"""PyTorch/CUDA port of SM3Det-TPU for NVIDIA Hopper.

A package beside ``sm3det_tpu`` (the JAX reference, which it never
imports). Plain tensor code is PyTorch; every Pallas kernel of the ported
path is a hand-written CUDA kernel under ``ops/cuda/csrc``. Public functions
keep the JAX package's NHWC layout. Entry points run on the CUDA card unless
the caller passes ``device="cpu"``, which runs each kernel's plain version.

What the port covers:

- inference of the flagship ``TriSourceDetector`` (``simple_test`` of
  "sar", "rgb" or "ifr", ``simple_test_joint``, ``aug_test``) and its
  train step (``train/``);
- evaluation over a dataset: ``python -m sm3det_tpu_torch.tools.test
  CONFIG [CKPT]`` reads a config file (``utils/config.py``), builds the
  detector (``models/builder.py``), loads its checkpoint
  (``train/checkpoint.py``), streams a dataset (``data/``) through the
  batched forward (``apis/eval_loop.py``) and scores it (VOC mAP on the
  card's IoU kernels, ``core/evaluation/eval_map.py``; the COCO protocol,
  ``coco_eval.py``) or writes the DOTA submission
  (``core/patch/split_merge.py``).
"""
