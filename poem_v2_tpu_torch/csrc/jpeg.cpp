// JPEG decode and encode through nvJPEG, for the data layer (data/codec.py).
//
// Not a kernel port: the JAX data layer decodes and encodes shard images with
// OpenCV on the host (poem_v2_tpu/data/wds.py:90-91, data/dumper.py:64-66), and
// the card's machine has no OpenCV. This shim binds nvJPEG from the CUDA toolkit
// with a plain C interface (ctypes); it is built as its own shared library
// (ops/_lib.py:jpeg), so the model's kernels do not depend on libnvjpeg.
//
// One nvJPEG handle a process; one decoder state, encoder state and parameters,
// stream and device buffer a thread (thread_local), since the datasets decode
// from a pool of threads (WORKERS_MODE: thread) and nvJPEG's states must not be
// shared between threads. Every call finishes its work on its own stream before
// it returns and hands the result to host memory the caller owns, so nothing
// it does is ordered against PyTorch's streams or allocator.
//
// Return codes: 0; a cudaError_t; 1000 + an nvjpegStatus_t; 2000 when the
// caller's output buffer is too small (encode: *length says what it needs).

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <mutex>

namespace {

constexpr int kNvjpegBase = 1000;
constexpr int kTooSmall = 2000;

#define POEM_CUDA(x)                                 \
  do {                                               \
    cudaError_t e_ = (x);                            \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)
#define POEM_NVJPEG(x)                               \
  do {                                               \
    nvjpegStatus_t s_ = (x);                         \
    if (s_ != NVJPEG_STATUS_SUCCESS) return kNvjpegBase + (int)s_; \
  } while (0)

std::mutex g_handle_mu;
nvjpegHandle_t g_handle = nullptr;

int handle(nvjpegHandle_t* out) {
  std::lock_guard<std::mutex> lock(g_handle_mu);
  if (g_handle == nullptr) POEM_NVJPEG(nvjpegCreateSimple(&g_handle));
  *out = g_handle;
  return 0;
}

// What one thread holds; released when the thread exits.
struct ThreadState {
  int device = -1;
  cudaStream_t stream = nullptr;
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  unsigned char* buf = nullptr;  // device: decoded RGB, or the image to encode
  size_t cap = 0;

  ~ThreadState() {
    if (params) nvjpegEncoderParamsDestroy(params);
    if (enc) nvjpegEncoderStateDestroy(enc);
    if (dec) nvjpegJpegStateDestroy(dec);
    if (buf) cudaFree(buf);
    if (stream) cudaStreamDestroy(stream);
  }
};

thread_local ThreadState t_state;

// The calling thread's state on ``device``, made at its first call.
int state(int device, nvjpegHandle_t* h, ThreadState** out) {
  int err = handle(h);
  if (err) return err;
  ThreadState& s = t_state;
  POEM_CUDA(cudaSetDevice(device));
  if (s.device != device) {
    if (s.device != -1) return (int)cudaErrorInvalidDevice;  // one device a thread
    POEM_CUDA(cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking));
    POEM_NVJPEG(nvjpegJpegStateCreate(*h, &s.dec));
    POEM_NVJPEG(nvjpegEncoderStateCreate(*h, &s.enc, s.stream));
    POEM_NVJPEG(nvjpegEncoderParamsCreate(*h, &s.params, s.stream));
    s.device = device;
  }
  *out = &s;
  return 0;
}

int reserve(ThreadState* s, size_t bytes) {
  if (bytes <= s->cap) return 0;
  if (s->buf) POEM_CUDA(cudaFree(s->buf));
  s->buf = nullptr;
  s->cap = 0;
  POEM_CUDA(cudaMalloc(&s->buf, bytes));
  s->cap = bytes;
  return 0;
}

}  // namespace

// Width and height of a JPEG stream (no device work).
extern "C" int poem_jpeg_info(const unsigned char* data, size_t length, int* width,
                              int* height) {
  nvjpegHandle_t h;
  int err = handle(&h);
  if (err) return err;
  int n_comp = 0;
  nvjpegChromaSubsampling_t sub;
  int ws[NVJPEG_MAX_COMPONENT], hs[NVJPEG_MAX_COMPONENT];
  POEM_NVJPEG(nvjpegGetImageInfo(h, data, length, &n_comp, &sub, ws, hs));
  *width = ws[0];
  *height = hs[0];
  return 0;
}

// Decode a JPEG stream on ``device`` to interleaved RGB (NVJPEG_OUTPUT_RGBI) and
// copy it into ``rgb`` (host, height * width * 3 bytes, from poem_jpeg_info).
extern "C" int poem_jpeg_decode(const unsigned char* data, size_t length, int width,
                                int height, int device, unsigned char* rgb) {
  nvjpegHandle_t h;
  ThreadState* s;
  int err = state(device, &h, &s);
  if (err) return err;
  const size_t pitch = (size_t)width * 3;
  err = reserve(s, pitch * height);
  if (err) return err;
  nvjpegImage_t out = {};
  out.channel[0] = s->buf;
  out.pitch[0] = pitch;
  POEM_NVJPEG(nvjpegDecode(h, s->dec, data, length, NVJPEG_OUTPUT_RGBI, &out, s->stream));
  POEM_CUDA(cudaMemcpyAsync(rgb, s->buf, pitch * height, cudaMemcpyDeviceToHost, s->stream));
  POEM_CUDA(cudaStreamSynchronize(s->stream));
  return 0;
}

// Encode ``rgb`` (host, height x width x 3, interleaved RGB) on ``device`` as a
// baseline JPEG at ``quality`` with 4:2:0 chroma (OpenCV's default sampling) into
// ``out`` (host, ``capacity`` bytes); ``*length`` receives the stream's size.
extern "C" int poem_jpeg_encode(const unsigned char* rgb, int width, int height,
                                int quality, int device, unsigned char* out,
                                size_t capacity, size_t* length) {
  nvjpegHandle_t h;
  ThreadState* s;
  int err = state(device, &h, &s);
  if (err) return err;
  const size_t pitch = (size_t)width * 3;
  err = reserve(s, pitch * height);
  if (err) return err;
  POEM_CUDA(cudaMemcpyAsync(s->buf, rgb, pitch * height, cudaMemcpyHostToDevice, s->stream));
  POEM_NVJPEG(nvjpegEncoderParamsSetQuality(s->params, quality, s->stream));
  POEM_NVJPEG(nvjpegEncoderParamsSetSamplingFactors(s->params, NVJPEG_CSS_420, s->stream));
  POEM_NVJPEG(nvjpegEncoderParamsSetOptimizedHuffman(s->params, 0, s->stream));
  nvjpegImage_t src = {};
  src.channel[0] = s->buf;
  src.pitch[0] = pitch;
  POEM_NVJPEG(nvjpegEncodeImage(h, s->enc, s->params, &src, NVJPEG_INPUT_RGBI, width, height,
                                s->stream));
  size_t n = 0;
  POEM_NVJPEG(nvjpegEncodeRetrieveBitstream(h, s->enc, nullptr, &n, s->stream));
  POEM_CUDA(cudaStreamSynchronize(s->stream));
  *length = n;
  if (n > capacity) return kTooSmall;
  POEM_NVJPEG(nvjpegEncodeRetrieveBitstream(h, s->enc, out, &n, s->stream));
  POEM_CUDA(cudaStreamSynchronize(s->stream));
  *length = n;
  return 0;
}
