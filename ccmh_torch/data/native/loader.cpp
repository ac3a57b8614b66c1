// Native batch image loader of ccmh_torch: JPEG decode + PIL-style
// antialiased bicubic resize + CLIP normalization, multi-threaded,
// GIL-free (every entry is called through ctypes).  The port's copy of
// ccmh's native loader, with two more entries that ccmh takes from PIL:
// ccmh_resize_u8 (in-memory uint8 arrays at another size) and
// ccmh_encode_jpeg_batch (baseline 4:2:0 JPEG at a given quality, PIL's
// Image.save(quality=...) settings).
//
// Transform (reference dataset/base.py:35-44):
//   train: resize short side to R (bicubic, antialiased), center crop RxR
//   eval:  resize to (R, R)
//   then:  /255, CLIP mean/std normalize, NHWC float32 -- or the uint8
//          image before normalization (the decoded-image cache payload)
//
// The decoder is chosen when the library is built (ccmh_torch/data/native/
// __init__.py), never at run time:
//   default        libjpeg (jpeglib.h), decode and encode on the host;
//   CCMH_NVJPEG    nvJPEG of the CUDA toolkit for the decode and encode
//                  stages only (RGB interleaved on the card, copied back to
//                  the host); the resize, crop and normalization are the same
//                  host code as above, so both builds share one cache format.
//
// The resampler reproduces PIL's convolution resampling (support-2 bicubic
// with a=-0.5, support scaled by the downscale factor) in float32; pixel
// differences vs PIL's fixed-point path are <= 2/255.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#ifdef CCMH_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace {

constexpr float kMean[3] = {0.48145466f, 0.4578275f, 0.40821073f};
constexpr float kStd[3] = {0.26862954f, 0.26130258f, 0.27577711f};
// (255 * (1/255) - mean) / std rounded after each operation, per channel
constexpr float kTop[3] = {(255.0f * (1.0f / 255.0f) - kMean[0]) / kStd[0],
                           (255.0f * (1.0f / 255.0f) - kMean[1]) / kStd[1],
                           (255.0f * (1.0f / 255.0f) - kMean[2]) / kStd[2]};

bool read_file(const char* path, std::vector<uint8_t>& data) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  std::fseek(fp, 0, SEEK_END);
  const long len = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  bool good = len > 0;
  if (good) {
    data.resize(static_cast<size_t>(len));
    good = std::fread(data.data(), 1, data.size(), fp) == data.size();
  }
  std::fclose(fp);
  return good;
}

#ifdef CCMH_NVJPEG
// ----------------------------------------------------------- nvJPEG stage
// One handle per process; each worker thread borrows a context (decoder
// state, encoder state, stream, device and pinned buffers) from a pool and
// returns it when its batch is done, so concurrent calls never share one.
std::atomic<int> g_device{0};
std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;

struct Ctx {
  int device = -1;
  cudaStream_t stream = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int enc_quality = -1;
  uint8_t* dev = nullptr;
  size_t dev_cap = 0;
  uint8_t* host = nullptr;
  size_t host_cap = 0;
};
std::vector<Ctx*> g_free;

Ctx* acquire() {
  const int device = g_device.load();
  std::lock_guard<std::mutex> lk(g_mu);
  if (cudaSetDevice(device) != cudaSuccess) return nullptr;
  if (g_handle == nullptr && nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS) {
    g_handle = nullptr;
    return nullptr;
  }
  for (size_t i = 0; i < g_free.size(); ++i) {
    if (g_free[i]->device == device) {
      Ctx* c = g_free[i];
      g_free.erase(g_free.begin() + i);
      return c;
    }
  }
  Ctx* c = new Ctx();
  c->device = device;
  if (cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking) != cudaSuccess ||
      nvjpegJpegStateCreate(g_handle, &c->state) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderStateCreate(g_handle, &c->enc_state, c->stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsCreate(g_handle, &c->enc_params, c->stream) != NVJPEG_STATUS_SUCCESS) {
    delete c;  // leaks what was created; the call reports failure
    return nullptr;
  }
  return c;
}

void release(Ctx* c) {
  if (c == nullptr) return;
  std::lock_guard<std::mutex> lk(g_mu);
  g_free.push_back(c);
}

bool grow_dev(Ctx* c, size_t need) {
  if (c->dev_cap >= need) return true;
  if (c->dev) cudaFree(c->dev);
  c->dev = nullptr;
  c->dev_cap = 0;
  if (cudaMalloc(&c->dev, need) != cudaSuccess) return false;
  c->dev_cap = need;
  return true;
}

bool grow_host(Ctx* c, size_t need) {
  if (c->host_cap >= need) return true;
  if (c->host) cudaFreeHost(c->host);
  c->host = nullptr;
  c->host_cap = 0;
  if (cudaMallocHost(&c->host, need) != cudaSuccess) return false;
  c->host_cap = need;
  return true;
}

// libjpeg's (6b / libjpeg-turbo) "fancy" chroma upsampling by 2, which PIL
// decodes with: a triangle filter, 3/4 of the nearer sample and 1/4 of the
// farther, with libjpeg's rounding biases; edge rows and columns replicate.
// nvJPEG's own RGB output upsamples by replication, up to 21 LSB away.
void fancy_h2v2(const uint8_t* in, int cw, int ch, uint8_t* out) {
  const int ow = 2 * cw;
  for (int r = 0; r < 2 * ch; ++r) {
    const int row = r / 2;
    const int nb = (r % 2 == 0) ? std::max(row - 1, 0) : std::min(row + 1, ch - 1);
    const uint8_t* p0 = in + static_cast<size_t>(row) * cw;
    const uint8_t* p1 = in + static_cast<size_t>(nb) * cw;
    uint8_t* o = out + static_cast<size_t>(r) * ow;
    int cur = p0[0] * 3 + p1[0], next = p0[1] * 3 + p1[1], last = cur;
    o[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
    o[1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
    last = cur;
    cur = next;
    for (int c = 1; c < cw - 1; ++c) {
      next = p0[c + 1] * 3 + p1[c + 1];
      o[2 * c] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
      o[2 * c + 1] = static_cast<uint8_t>((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
    }
    o[ow - 2] = static_cast<uint8_t>((cur * 3 + last + 8) >> 4);
    o[ow - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
  }
}

void fancy_h2v1(const uint8_t* in, int cw, int ch, uint8_t* out) {
  const int ow = 2 * cw;
  for (int r = 0; r < ch; ++r) {
    const uint8_t* p = in + static_cast<size_t>(r) * cw;
    uint8_t* o = out + static_cast<size_t>(r) * ow;
    o[0] = p[0];
    o[1] = static_cast<uint8_t>((p[0] * 3 + p[1] + 2) >> 2);
    for (int c = 1; c < cw - 1; ++c) {
      const int v = p[c] * 3;
      o[2 * c] = static_cast<uint8_t>((v + p[c - 1] + 1) >> 2);
      o[2 * c + 1] = static_cast<uint8_t>((v + p[c + 1] + 2) >> 2);
    }
    o[ow - 2] = static_cast<uint8_t>((p[cw - 1] * 3 + p[cw - 2] + 1) >> 2);
    o[ow - 1] = p[cw - 1];
  }
}

// Replication (libjpeg's choice for planes of two samples or fewer).
void replicate(const uint8_t* in, int cw, int ch, int fy, uint8_t* out) {
  const int ow = 2 * cw;
  for (int r = 0; r < ch * fy; ++r) {
    const uint8_t* p = in + static_cast<size_t>(r / fy) * cw;
    uint8_t* o = out + static_cast<size_t>(r) * ow;
    for (int c = 0; c < ow; ++c) o[c] = p[c / 2];
  }
}

// libjpeg's YCbCr -> RGB in 16-bit fixed point (jdcolor.c), range-limited.
struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kBits = 16;
    constexpr int64_t kHalf = int64_t(1) << (kBits - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (int64_t(1) << kBits) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
      cr_g[i] = static_cast<int>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int>(-fix(0.34414) * x + kHalf);
    }
  }
};

inline uint8_t clamp8(int v) { return static_cast<uint8_t>(std::min(std::max(v, 0), 255)); }

// Decode one JPEG to interleaved RGB in the context's pinned buffer.  The
// card decodes to planar Y, Cb, Cr at their sampled sizes; the chroma is
// upsampled and converted here as libjpeg does (4:4:4, 4:2:2, 4:2:0).  A
// grayscale JPEG decodes to its Y plane, replicated as libjpeg's JCS_RGB
// output and PIL's convert("RGB") do; other samplings take nvJPEG's RGB.
bool decode_jpeg_mem(Ctx* c, const uint8_t* buf, size_t len, const uint8_t** rgb,
                     int& w, int& h) {
  static const YccTables ycc;
  if (c == nullptr || buf == nullptr || len == 0) return false;
  int n_comp = 0;
  nvjpegChromaSubsampling_t css;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(g_handle, buf, len, &n_comp, &css, ws, hs) != NVJPEG_STATUS_SUCCESS)
    return false;
  w = ws[0];
  h = hs[0];
  if (w <= 0 || h <= 0 || (n_comp != 1 && n_comp != 3)) return false;
  const bool gray = n_comp == 1 || css == NVJPEG_CSS_GRAY;
  const int fx = css == NVJPEG_CSS_444 ? 1 : 2;
  const int fy = css == NVJPEG_CSS_420 ? 2 : 1;
  const bool planar = !gray &&
                      (css == NVJPEG_CSS_444 || css == NVJPEG_CSS_422 || css == NVJPEG_CSS_420) &&
                      ws[1] == (w + fx - 1) / fx && hs[1] == (h + fy - 1) / fy &&
                      ws[2] == ws[1] && hs[2] == hs[1];
  const size_t npx = static_cast<size_t>(w) * h;
  const size_t ncx = planar ? static_cast<size_t>(ws[1]) * hs[1] : 0;
  // device: the decode; host: RGB (3 npx), then the planes or Y (npx + 2 ncx),
  // then two upsampled chroma planes (2 x (2 cw) x (2 ch))
  const size_t up = planar ? static_cast<size_t>(2 * ws[1]) * (2 * hs[1]) : 0;
  if (!grow_dev(c, std::max(npx * 3, npx + 2 * ncx)) ||
      !grow_host(c, npx * 3 + npx + 2 * ncx + 2 * up))
    return false;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  nvjpegOutputFormat_t fmt;
  size_t bytes;
  if (gray) {
    fmt = NVJPEG_OUTPUT_Y;
    img.channel[0] = c->dev;
    img.pitch[0] = w;
    bytes = npx;
  } else if (planar) {
    fmt = NVJPEG_OUTPUT_YUV;
    img.channel[0] = c->dev;
    img.pitch[0] = w;
    img.channel[1] = c->dev + npx;
    img.pitch[1] = ws[1];
    img.channel[2] = c->dev + npx + ncx;
    img.pitch[2] = ws[1];
    bytes = npx + 2 * ncx;
  } else {
    fmt = NVJPEG_OUTPUT_RGBI;
    img.channel[0] = c->dev;
    img.pitch[0] = w * 3;
    bytes = npx * 3;
  }
  if (nvjpegDecode(g_handle, c->state, buf, len, fmt, &img, c->stream) != NVJPEG_STATUS_SUCCESS)
    return false;
  uint8_t* dst = c->host;
  uint8_t* landing = (gray || planar) ? c->host + npx * 3 : dst;
  if (cudaMemcpyAsync(landing, c->dev, bytes, cudaMemcpyDeviceToHost, c->stream) != cudaSuccess ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return false;
  if (gray) {
    for (size_t i = 0; i < npx; ++i) dst[i * 3] = dst[i * 3 + 1] = dst[i * 3 + 2] = landing[i];
  } else if (planar) {
    const uint8_t* y = landing;
    const uint8_t* cb = landing + npx;
    const uint8_t* cr = landing + npx + ncx;
    int stride = w;  // of the chroma planes at full size
    if (fx == 2) {
      const int cw = ws[1], chh = hs[1];
      uint8_t* ucb = landing + npx + 2 * ncx;
      uint8_t* ucr = ucb + up;
      for (int k = 0; k < 2; ++k) {
        const uint8_t* src = k == 0 ? cb : cr;
        uint8_t* o = k == 0 ? ucb : ucr;
        if (cw <= 2)
          replicate(src, cw, chh, fy, o);
        else if (fy == 2)
          fancy_h2v2(src, cw, chh, o);
        else
          fancy_h2v1(src, cw, chh, o);
      }
      cb = ucb;
      cr = ucr;
      stride = 2 * cw;
    }
    for (int r = 0; r < h; ++r) {
      const uint8_t* yr = y + static_cast<size_t>(r) * w;
      const uint8_t* br = cb + static_cast<size_t>(r) * stride;
      const uint8_t* rr = cr + static_cast<size_t>(r) * stride;
      uint8_t* o = dst + static_cast<size_t>(r) * w * 3;
      for (int x = 0; x < w; ++x) {
        const int yy = yr[x], b = br[x], rc = rr[x];
        o[3 * x] = clamp8(yy + ycc.cr_r[rc]);
        o[3 * x + 1] = clamp8(yy + ((ycc.cb_g[b] + ycc.cr_g[rc]) >> 16));
        o[3 * x + 2] = clamp8(yy + ycc.cb_b[b]);
      }
    }
  }
  *rgb = dst;
  return true;
}

bool encode_jpeg(Ctx* c, const uint8_t* rgb, int w, int h, int quality,
                 std::vector<uint8_t>& out) {
  if (c == nullptr) return false;
  if (c->enc_quality != quality) {
    if (nvjpegEncoderParamsSetQuality(c->enc_params, quality, c->stream) != NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsSetSamplingFactors(c->enc_params, NVJPEG_CSS_420, c->stream) !=
            NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsSetOptimizedHuffman(c->enc_params, 0, c->stream) != NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsSetEncoding(c->enc_params, NVJPEG_ENCODING_BASELINE_DCT, c->stream) !=
            NVJPEG_STATUS_SUCCESS)
      return false;
    c->enc_quality = quality;
  }
  const size_t bytes = static_cast<size_t>(w) * h * 3;
  if (!grow_dev(c, bytes)) return false;
  if (cudaMemcpyAsync(c->dev, rgb, bytes, cudaMemcpyHostToDevice, c->stream) != cudaSuccess)
    return false;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = c->dev;
  img.pitch[0] = w * 3;
  if (nvjpegEncodeImage(g_handle, c->enc_state, c->enc_params, &img, NVJPEG_INPUT_RGBI, w, h,
                        c->stream) != NVJPEG_STATUS_SUCCESS)
    return false;
  size_t len = 0;
  if (nvjpegEncodeRetrieveBitstream(g_handle, c->enc_state, nullptr, &len, c->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return false;
  out.resize(len);
  if (nvjpegEncodeRetrieveBitstream(g_handle, c->enc_state, out.data(), &len, c->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return false;
  out.resize(len);
  return true;
}

constexpr const char* kDecoder = "nvjpeg";
#else
// ---------------------------------------------------------- libjpeg stage
struct Ctx {
  std::vector<uint8_t> rgb;
};

Ctx* acquire() { return new Ctx(); }
void release(Ctx* c) { delete c; }

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg_mem(Ctx* c, const uint8_t* buf, size_t len, const uint8_t** rgb,
                     int& w, int& h) {
  if (buf == nullptr || len == 0) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  c->rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = c->rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *rgb = c->rgb.data();
  return true;
}

// Baseline JPEG, 4:2:0 (libjpeg's default sampling for YCbCr), standard
// Huffman tables: the settings of PIL's Image.save(path, quality=q).
bool encode_jpeg(Ctx*, const uint8_t* rgb, int w, int h, int quality,
                 std::vector<uint8_t>& out) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    std::free(mem);
    return false;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) + static_cast<size_t>(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  out.assign(mem, mem + mem_len);
  jpeg_destroy_compress(&cinfo);
  std::free(mem);
  return true;
}

constexpr const char* kDecoder = "libjpeg";
#endif

// PIL bicubic kernel (a = -0.5), support 2.
inline float bicubic(float x) {
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

struct FilterTable {
  int ksize;                 // taps per output pixel
  std::vector<int> bounds;   // [out, 2] (start, count)
  std::vector<float> coeffs; // [out, ksize]
};

// PIL-style antialiased coefficients for in_size -> out_size.
FilterTable make_filter(int in_size, int out_size) {
  FilterTable t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double fscale = std::max(scale, 1.0);
  const double support = 2.0 * fscale;     // bicubic support * antialias
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.bounds.resize(out_size * 2);
  t.coeffs.assign(static_cast<size_t>(out_size) * t.ksize, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    float* k = &t.coeffs[static_cast<size_t>(xx) * t.ksize];
    double ss = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double wgt = bicubic(static_cast<float>((x + xmin - center + 0.5) / fscale));
      k[x] = static_cast<float>(wgt);
      ss += wgt;
    }
    if (ss != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] = static_cast<float>(k[x] / ss);
    t.bounds[xx * 2] = xmin;
    t.bounds[xx * 2 + 1] = xmax;
  }
  return t;
}

// Separable resize, planar per channel (contiguous inner loops that the
// compiler vectorises).  src and dst are interleaved RGB.
void resize_rgb(const float* src, int sw, int sh, float* dst, int dw, int dh) {
  FilterTable fh = make_filter(sw, dw);
  FilterTable fv = make_filter(sh, dh);
  std::vector<float> plane(static_cast<size_t>(sw) * sh);
  std::vector<float> tmp(static_cast<size_t>(sh) * dw);
  std::vector<float> out_plane(static_cast<size_t>(dh) * dw);
  for (int c = 0; c < 3; ++c) {
    const size_t npx = static_cast<size_t>(sw) * sh;
    for (size_t i = 0; i < npx; ++i) plane[i] = src[i * 3 + c];
    // horizontal pass; PIL keeps the intermediate as uint8 (clip, round
    // half up), else bicubic overshoot on high-contrast data diverges
    for (int y = 0; y < sh; ++y) {
      const float* srow = plane.data() + static_cast<size_t>(y) * sw;
      float* trow = tmp.data() + static_cast<size_t>(y) * dw;
      for (int x = 0; x < dw; ++x) {
        const int xmin = fh.bounds[x * 2], xmax = fh.bounds[x * 2 + 1];
        const float* k = &fh.coeffs[static_cast<size_t>(x) * fh.ksize];
        const float* p = srow + xmin;
        float acc = 0.0f;
        for (int i = 0; i < xmax; ++i) acc += p[i] * k[i];
        trow[x] = static_cast<float>(static_cast<int>(
            std::min(std::max(acc, 0.0f), 255.0f) + 0.5f));
      }
    }
    // vertical pass: accumulate rows (contiguous, vectorises over x)
    for (int y = 0; y < dh; ++y) {
      const int ymin = fv.bounds[y * 2], ymax = fv.bounds[y * 2 + 1];
      const float* k = &fv.coeffs[static_cast<size_t>(y) * fv.ksize];
      float* drow = out_plane.data() + static_cast<size_t>(y) * dw;
      std::memset(drow, 0, sizeof(float) * dw);
      for (int i = 0; i < ymax; ++i) {
        const float ki = k[i];
        const float* trow = tmp.data() + static_cast<size_t>(ymin + i) * dw;
        for (int x = 0; x < dw; ++x) drow[x] += trow[x] * ki;
      }
    }
    const size_t dpx = static_cast<size_t>(dw) * dh;
    for (size_t i = 0; i < dpx; ++i) dst[i * 3 + c] = out_plane[i];
  }
}

// One item: (train: short-side resize + center crop | eval: square
// resize) -> exactly one of
//   out_f32[R, R, 3]  CLIP-normalized float32
//   out_u8 [R, R, 3]  post-resize uint8 before normalization (the decoded-
//                     image cache payload; the tower normalizes on the card)
bool process_rgb(const uint8_t* rgb, int w, int h, int resolution, int is_train,
                 float* out_f32, uint8_t* out_u8) {
  const size_t n = static_cast<size_t>(w) * h * 3;
  std::vector<float> fsrc(n);
  for (size_t i = 0; i < n; ++i) fsrc[i] = static_cast<float>(rgb[i]);

  const int R = resolution;
  std::vector<float> resized;
  int cw, ch;
  if (is_train) {
    // round(dim * R / short) as Python's round() (half to even): std::lrint
    // in the default rounding mode; std::lround would shift the crop by 1 px
    // on exact .5 scales
    const int short_side = std::min(w, h);
    const double scale = static_cast<double>(R) / short_side;
    cw = static_cast<int>(std::lrint(w * scale));
    ch = static_cast<int>(std::lrint(h * scale));
  } else {
    cw = R;
    ch = R;
  }
  resized.resize(static_cast<size_t>(cw) * ch * 3);
  resize_rgb(fsrc.data(), w, h, resized.data(), cw, ch);
  const int left = (cw - R) / 2;
  const int top = (ch - R) / 2;
  for (int y = 0; y < R; ++y) {
    const float* srow = resized.data() + (static_cast<size_t>(top + y) * cw + left) * 3;
    for (int x = 0; x < R; ++x) {
      for (int c = 0; c < 3; ++c) {
        // PIL rounds the resampled float back to uint8 (half up)
        const float raw = srow[x * 3 + c];
        const float v = std::min(std::max(raw, 0.0f), 255.0f);
        const int q = static_cast<int>(v + 0.5f);
        const size_t o = (static_cast<size_t>(y) * R + x) * 3 + c;
        if (out_u8 != nullptr) {
          out_u8[o] = static_cast<uint8_t>(q);
        } else {
          // the bits of ccmh's g++ build of (q * (1/255) - mean) / std: the
          // product and the difference fuse into one FMA, except where the
          // value clamps above 255, where the compiler folds the constant
          out_f32[o] = raw > 255.0f
                           ? kTop[c]
                           : std::fma(static_cast<float>(q), 1.0f / 255.0f, -kMean[c]) / kStd[c];
        }
      }
    }
  }
  return true;
}

bool load_one_mem(Ctx* c, const uint8_t* buf, size_t len, int resolution, int is_train,
                  float* out_f32, uint8_t* out_u8) {
  const uint8_t* rgb = nullptr;
  int w = 0, h = 0;
  if (!decode_jpeg_mem(c, buf, len, &rgb, w, h)) return false;
  return process_rgb(rgb, w, h, resolution, is_train, out_f32, out_u8);
}

bool load_one(Ctx* c, const char* path, int resolution, int is_train, float* out_f32,
              uint8_t* out_u8) {
  std::vector<uint8_t> data;
  if (!read_file(path, data)) return false;
  return load_one_mem(c, data.data(), data.size(), resolution, is_train, out_f32, out_u8);
}

// Run item(ctx, i) for i in [0, n) over n_threads workers, each holding
// one context; ok[i] = 1 on success.  Returns the count of failures.
template <class F>
int run_batch(int n, int n_threads, uint8_t* ok, F item) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    Ctx* c = acquire();
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const bool good = c != nullptr && item(c, i);
      ok[i] = good ? 1 : 0;
      if (!good) failures.fetch_add(1);
    }
    release(c);
  };
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // namespace

extern "C" {

// "libjpeg" or "nvjpeg": the decoder this library was built with.
const char* ccmh_decoder_name() { return kDecoder; }

// The card nvJPEG decodes and encodes on (nvjpeg builds; ignored otherwise).
void ccmh_loader_set_device(int device) {
#ifdef CCMH_NVJPEG
  g_device.store(device);
#else
  (void)device;
#endif
}

// JPEG paths -> out[n, R, R, 3] float32 NHWC, CLIP-normalized.
int ccmh_batch_load(const char** paths, int n, int resolution, int is_train, float* out,
                    uint8_t* ok, int n_threads) {
  const size_t stride = static_cast<size_t>(resolution) * resolution * 3;
  return run_batch(n, n_threads, ok, [&](Ctx* c, int i) {
    return load_one(c, paths[i], resolution, is_train, out + stride * i, nullptr);
  });
}

// JPEG paths -> out[n, R, R, 3] uint8 (after the resize, before the
// normalization): the decoded-image cache payload.
int ccmh_batch_load_u8(const char** paths, int n, int resolution, int is_train,
                       uint8_t* out, uint8_t* ok, int n_threads) {
  const size_t stride = static_cast<size_t>(resolution) * resolution * 3;
  return run_batch(n, n_threads, ok, [&](Ctx* c, int i) {
    return load_one(c, paths[i], resolution, is_train, nullptr, out + stride * i);
  });
}

// In-memory JPEG files (the serving path) -> float32 as ccmh_batch_load.
int ccmh_batch_load_mem(const uint8_t** bufs, const int64_t* lens, int n, int resolution,
                        int is_train, float* out, uint8_t* ok, int n_threads) {
  const size_t stride = static_cast<size_t>(resolution) * resolution * 3;
  return run_batch(n, n_threads, ok, [&](Ctx* c, int i) {
    return load_one_mem(c, bufs[i], static_cast<size_t>(lens[i]), resolution, is_train,
                        out + stride * i, nullptr);
  });
}

// One interleaved RGB uint8 array [h, w, 3] -> out[R, R, 3] uint8 by the
// same transform (PIL's Image.fromarray(a) then resize and crop).
int ccmh_resize_u8(const uint8_t* rgb, int w, int h, int resolution, int is_train,
                   uint8_t* out) {
  if (rgb == nullptr || w <= 0 || h <= 0) return 0;
  return process_rgb(rgb, w, h, resolution, is_train, nullptr, out) ? 1 : 0;
}

// n interleaved RGB uint8 images -> baseline 4:2:0 JPEG files at quality.
// outs[i] holds caps[i] bytes; lens[i] gets the file's length, or minus
// the length needed when caps[i] is too small, or 0 when encoding failed.
int ccmh_encode_jpeg_batch(const uint8_t** rgbs, const int* ws, const int* hs, int n,
                           int quality, uint8_t** outs, const int64_t* caps, int64_t* lens,
                           uint8_t* ok, int n_threads) {
  return run_batch(n, n_threads, ok, [&](Ctx* c, int i) {
    std::vector<uint8_t> jpg;
    lens[i] = 0;
    if (!encode_jpeg(c, rgbs[i], ws[i], hs[i], quality, jpg)) return false;
    const int64_t len = static_cast<int64_t>(jpg.size());
    if (len > caps[i]) {
      lens[i] = -len;
      return false;
    }
    std::memcpy(outs[i], jpg.data(), jpg.size());
    lens[i] = len;
    return true;
  });
}

}  // extern "C"
