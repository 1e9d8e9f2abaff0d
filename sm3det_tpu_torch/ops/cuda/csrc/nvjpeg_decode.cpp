// JPEG decoding on the card through nvJPEG (the CUDA toolkit's decoder).
//
// Replaces: no Pallas kernel. The JAX package decodes JPEG on the host
//   through PIL (sm3det_tpu/utils/image.py:47); the port reads images
//   without PIL, so its reader (sm3det_tpu_torch/utils/image.py) hands
//   JPEG files to nvJPEG. Built on first use into a library of its own
//   (ops/cuda/nvjpeg.py), so that a toolkit without libnvjpeg cannot break
//   the kernel library.
//
// Contract: a context holds an nvJPEG handle, a decode state, a stream of
//   its own, a device buffer and a host buffer that grow to the largest
//   image seen (a context serves one thread at a time).
//   sm3det_nvjpeg_decode decodes on the context's stream and waits for
//   that stream only: no other stream of the process waits. channels 1
//   gives the luma plane. channels 3 of a 4:4:4, 4:2:2 or 4:2:0 YCbCr file
//   decodes the component planes on the card and makes RGB on the host as
//   libjpeg does by default (PIL's decoder): the chroma upsampled by its
//   "fancy" triangle filter (3/4 of the nearer sample, 1/4 of the farther,
//   with its rounding), then its fixed-point YCbCr -> RGB tables; so only
//   the IDCTs differ. Other subsamplings take nvJPEG's own interleaved
//   RGB. Every entry returns 0 or an error code: nvJPEG's status, or
//   1000 + a cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

struct Ctx {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* buf = nullptr;
  size_t cap = 0;
  std::vector<uint8_t> planes;   // the component planes on the host
  int device = 0;
};

// libjpeg's jdcolor.c tables (SCALEBITS 16, rounding by ONE_HALF)
struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int one_half = 1 << 15;
    auto fix = [](double x) { return static_cast<int>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int x = i - 128;
      cr_r[i] = (fix(1.40200) * x + one_half) >> 16;
      cb_b[i] = (fix(1.77200) * x + one_half) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// libjpeg's h2v1_fancy_upsample: one row of cw samples -> 2 cw
void upsample_h2v1(const uint8_t* in, int cw, uint8_t* out) {
  if (cw == 1) {
    out[0] = out[1] = in[0];
    return;
  }
  out[0] = in[0];
  out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
  for (int c = 1; c < cw - 1; ++c) {
    const int v = in[c] * 3;
    out[2 * c] = static_cast<uint8_t>((v + in[c - 1] + 1) >> 2);
    out[2 * c + 1] = static_cast<uint8_t>((v + in[c + 1] + 2) >> 2);
  }
  out[2 * cw - 2] = static_cast<uint8_t>((in[cw - 1] * 3 + in[cw - 2] + 1) >> 2);
  out[2 * cw - 1] = in[cw - 1];
}

// libjpeg's h2v2_fancy_upsample, one output row: ``near`` the nearer input
// row, ``far`` the farther (the row itself at the image's edges)
void upsample_h2v2_row(const uint8_t* near, const uint8_t* far, int cw,
                       uint8_t* out) {
  if (cw == 1) {
    out[0] = out[1] = static_cast<uint8_t>((near[0] * 12 + far[0] * 4 + 8) >> 4);
    return;
  }
  int this_sum = near[0] * 3 + far[0];
  int next_sum = near[1] * 3 + far[1];
  out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int c = 1; c < cw - 1; ++c) {
    next_sum = near[c + 1] * 3 + far[c + 1];
    out[2 * c] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * c + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * cw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * cw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
}

// the planes Y (w0 x h0), Cb, Cr (w1 x h1) -> HWC RGB (width x height)
void ycc_to_rgb(const uint8_t* y, int w0, const uint8_t* cb,
                const uint8_t* cr, int w1, int h1, int hs, int vs, int width,
                int height, uint8_t* rgb) {
  static const YccTables t;
  std::vector<uint8_t> ucb(2 * w1 + 2), ucr(2 * w1 + 2);
  for (int r = 0; r < height; ++r) {
    const uint8_t *rowb, *rowr;
    if (hs == 1 && vs == 1) {
      rowb = cb + static_cast<size_t>(r) * w1;
      rowr = cr + static_cast<size_t>(r) * w1;
    } else if (vs == 1) {
      upsample_h2v1(cb + static_cast<size_t>(r) * w1, w1, ucb.data());
      upsample_h2v1(cr + static_cast<size_t>(r) * w1, w1, ucr.data());
      rowb = ucb.data();
      rowr = ucr.data();
    } else {
      const int in = r / 2;
      int far = (r % 2 == 0) ? in - 1 : in + 1;
      far = far < 0 ? 0 : (far > h1 - 1 ? h1 - 1 : far);
      upsample_h2v2_row(cb + static_cast<size_t>(in) * w1,
                        cb + static_cast<size_t>(far) * w1, w1, ucb.data());
      upsample_h2v2_row(cr + static_cast<size_t>(in) * w1,
                        cr + static_cast<size_t>(far) * w1, w1, ucr.data());
      rowb = ucb.data();
      rowr = ucr.data();
    }
    const uint8_t* rowy = y + static_cast<size_t>(r) * w0;
    uint8_t* out = rgb + static_cast<size_t>(r) * width * 3;
    for (int c = 0; c < width; ++c) {
      const int yy = rowy[c], b = rowb[c], rr = rowr[c];
      out[3 * c] = clamp255(yy + t.cr_r[rr]);
      out[3 * c + 1] = clamp255(yy + ((t.cb_g[b] + t.cr_g[rr]) >> 16));
      out[3 * c + 2] = clamp255(yy + t.cb_b[b]);
    }
  }
}

int reserve(Ctx* c, size_t need) {
  if (need <= c->cap) return 0;
  // stream-ordered: no wait on the rest of the device
  if (c->buf) cudaFreeAsync(c->buf, c->stream);
  c->buf = nullptr;
  c->cap = 0;
  cudaError_t e = cudaMallocAsync(reinterpret_cast<void**>(&c->buf), need,
                                  c->stream);
  if (e != cudaSuccess) return 1000 + e;
  c->cap = need;
  return 0;
}

}  // namespace

extern "C" int sm3det_nvjpeg_create(void** out, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return 1000 + e;
  Ctx* c = new Ctx();
  c->device = device;
  nvjpegStatus_t s = nvjpegCreateSimple(&c->handle);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegJpegStateCreate(c->handle,
                                                            &c->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    delete c;
    return static_cast<int>(s);
  }
  e = cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking);
  if (e != cudaSuccess) {
    delete c;
    return 1000 + e;
  }
  *out = c;
  return 0;
}

extern "C" int sm3det_nvjpeg_info(void* ctx, const uint8_t* data,
                                  size_t len, int* components, int* width,
                                  int* height) {
  Ctx* c = static_cast<Ctx*>(ctx);
  int nc = 0;
  nvjpegChromaSubsampling_t sub;
  int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT];
  nvjpegStatus_t s = nvjpegGetImageInfo(c->handle, data, len, &nc, &sub, w,
                                        h);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  *components = nc;
  *width = w[0];
  *height = h[0];
  return 0;
}

extern "C" int sm3det_nvjpeg_decode(void* ctx, const uint8_t* data,
                                    size_t len, int channels, uint8_t* host,
                                    int width, int height) {
  Ctx* c = static_cast<Ctx*>(ctx);
  cudaError_t e = cudaSetDevice(c->device);
  if (e != cudaSuccess) return 1000 + e;
  int nc = 0;
  nvjpegChromaSubsampling_t sub;
  int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT];
  nvjpegStatus_t s = nvjpegGetImageInfo(c->handle, data, len, &nc, &sub, w,
                                        h);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  int hs = 0, vs = 0;               // chroma subsampling we upsample here
  if (channels == 3 && nc == 3) {
    if (sub == NVJPEG_CSS_444) hs = vs = 1;
    if (sub == NVJPEG_CSS_422) hs = 2, vs = 1;
    if (sub == NVJPEG_CSS_420) hs = vs = 2;
  }
  nvjpegImage_t img = {};
  size_t need;
  nvjpegOutputFormat_t fmt;
  if (hs) {
    const size_t p0 = static_cast<size_t>(w[0]) * h[0];
    const size_t p1 = static_cast<size_t>(w[1]) * h[1];
    need = p0 + 2 * p1;
    int rc = reserve(c, need);
    if (rc) return rc;
    img.channel[0] = c->buf;
    img.channel[1] = c->buf + p0;
    img.channel[2] = c->buf + p0 + p1;
    img.pitch[0] = static_cast<unsigned int>(w[0]);
    img.pitch[1] = img.pitch[2] = static_cast<unsigned int>(w[1]);
    fmt = NVJPEG_OUTPUT_YUV;
  } else {
    need = static_cast<size_t>(width) * height * channels;
    int rc = reserve(c, need);
    if (rc) return rc;
    img.channel[0] = c->buf;
    img.pitch[0] = static_cast<unsigned int>(width) * channels;
    fmt = channels == 3 ? NVJPEG_OUTPUT_RGBI : NVJPEG_OUTPUT_Y;
  }
  s = nvjpegDecode(c->handle, c->state, data, len, fmt, &img, c->stream);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  uint8_t* dst = host;
  if (hs) {
    c->planes.resize(need);
    dst = c->planes.data();
  }
  e = cudaMemcpyAsync(dst, c->buf, need, cudaMemcpyDeviceToHost, c->stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(c->stream);
  if (e != cudaSuccess) return 1000 + e;
  if (hs) {
    const uint8_t* y = c->planes.data();
    const uint8_t* cb = y + static_cast<size_t>(w[0]) * h[0];
    const uint8_t* cr = cb + static_cast<size_t>(w[1]) * h[1];
    ycc_to_rgb(y, w[0], cb, cr, w[1], h[1], hs, vs, width, height, host);
  }
  return 0;
}
