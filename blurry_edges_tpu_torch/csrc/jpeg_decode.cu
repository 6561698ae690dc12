// JPEG decoding on the card through nvJPEG, the CUDA toolkit's JPEG
// decoder, with a plain C interface for ctypes (data/imageio.py).
//
// It replaces no TPU kernel: the JAX package reads its MS-COCO and Painting
// JPEGs on the host with OpenCV's libjpeg (cv2.imread in
// blurry_edges_tpu/data/realistic_gen.py). This is the card's decoder for
// the same function, so the decoded pixels land in device memory, in the
// tensors that the test-set renderer reads. Built into its own library,
// _build/libimage_<hash>.so, linked with -lnvjpeg; the kernels' library
// does not depend on nvJPEG.
//
// One nvJPEG handle and decoder state per device and process, made at the
// first call; calls are serialised by a mutex (ctypes releases the GIL).
// Each call makes `device` current for its work and gives the calling
// thread back its own current device before it returns. Every function
// returns 0, an nvjpegStatus_t, or 1000 + a cudaError_t; it never aborts.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstring>
#include <mutex>

namespace {

constexpr int kMaxDevices = 16;
constexpr int kCudaErrorBase = 1000;

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

Decoder g_decoders[kMaxDevices];
std::mutex g_mutex;

// Restores the thread's current device when it leaves scope.
struct DeviceGuard {
  int previous = -1;
  ~DeviceGuard() {
    if (previous >= 0) cudaSetDevice(previous);
  }
};

int get_decoder(int device, DeviceGuard& guard, Decoder** out) {
  if (device < 0 || device >= kMaxDevices) return NVJPEG_STATUS_INVALID_PARAMETER;
  cudaError_t ce = cudaGetDevice(&guard.previous);
  if (ce != cudaSuccess) return kCudaErrorBase + ce;
  ce = cudaSetDevice(device);
  if (ce != cudaSuccess) return kCudaErrorBase + ce;
  Decoder& d = g_decoders[device];
  if (d.handle == nullptr) {
    nvjpegStatus_t st = nvjpegCreateSimple(&d.handle);
    if (st != NVJPEG_STATUS_SUCCESS) {
      d.handle = nullptr;
      return st;
    }
    st = nvjpegJpegStateCreate(d.handle, &d.state);
    if (st != NVJPEG_STATUS_SUCCESS) {
      nvjpegDestroy(d.handle);
      d.handle = nullptr;
      return st;
    }
  }
  *out = &d;
  return 0;
}

}  // namespace

extern "C" {

// The number of components and each component's width and height (four
// entries each; component 0 is at full resolution).
int jpeg_info(const unsigned char* data, size_t length, int device, int* components,
              int* widths, int* heights) {
  std::lock_guard<std::mutex> lock(g_mutex);
  DeviceGuard guard;
  Decoder* d = nullptr;
  int rc = get_decoder(device, guard, &d);
  if (rc != 0) return rc;
  nvjpegChromaSubsampling_t subsampling;
  return nvjpegGetImageInfo(d->handle, data, length, components, &subsampling, widths, heights);
}

// Decodes into device memory the caller allocated, in one of two forms:
// 1 the luma plane alone (a gray JPEG), 2 the Y, Cb and Cr planes at their
// own (subsampled) sizes in planes 0-2; the caller upsamples and converts
// them as libjpeg does. `pitches` are bytes a row. Waits for the stream
// before it returns, so the host bytes may be freed at once.
int jpeg_decode(const unsigned char* data, size_t length, int device, int form,
                void* plane0, void* plane1, void* plane2, const int* pitches, void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  DeviceGuard guard;
  Decoder* d = nullptr;
  int rc = get_decoder(device, guard, &d);
  if (rc != 0) return rc;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  if (form != 1 && form != 2) return NVJPEG_STATUS_INVALID_PARAMETER;
  void* planes[3] = {plane0, plane1, plane2};
  for (int c = 0; c < (form == 2 ? 3 : 1); ++c) {
    image.channel[c] = static_cast<unsigned char*>(planes[c]);
    image.pitch[c] = static_cast<unsigned int>(pitches[c]);
  }
  const nvjpegOutputFormat_t format = form == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t st = nvjpegDecode(d->handle, d->state, data, length, format, &image, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  cudaError_t ce = cudaStreamSynchronize(s);
  if (ce != cudaSuccess) return kCudaErrorBase + ce;
  ce = cudaGetLastError();
  return ce == cudaSuccess ? 0 : kCudaErrorBase + ce;
}

}  // extern "C"
