// JPEG decode and encode on the card through nvJPEG (CUDA toolkit), the
// data layer's image route on a machine with a GPU.  The host route is
// native/fastloader.cpp (libjpeg); the card's machine has no libjpeg, so
// decoding there goes through nvJPEG, and the frames land on the device,
// where the resize, crop, flip and normalization run as PyTorch ops
// (data/nvjpeg_loader.py).  Host code only: no kernel of this file
// replaces a TPU kernel.
//
// C ABI (ctypes).  Every function returns 0, else 1000 + an nvjpegStatus_t
// or 2000 + a cudaError_t.
//   int nvj_image_info(const unsigned char* data, size_t len,
//                      int* h, int* w);
//   int nvj_decode_rgbi(const unsigned char* data, size_t len,
//                       void* out, int pitch, void* stream);
//       out: device buffer of h * pitch bytes, interleaved RGB rows
//   int nvj_encode_rgbi(const void* src, int h, int w, int pitch,
//                       int quality, unsigned char* out, size_t cap,
//                       size_t* out_len, void* stream);
//       src: device buffer, interleaved RGB rows; out: host buffer of cap
//       bytes; 4:2:0 chroma, baseline Huffman tables (libjpeg's defaults);
//       returns 3, with out_len set, when the bitstream exceeds cap
// The data buffers are host memory.  Calls are synchronous with the host
// and must not run from two threads at once (one decoder state).
//
// Build: nvcc -shared -Xcompiler -fPIC nvjpeg_codec.cu -lnvjpeg

#include <cstring>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Codec {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
};

Codec g_codec;

int status(nvjpegStatus_t s) { return s == NVJPEG_STATUS_SUCCESS ? 0 : 1000 + s; }

int cuda_status(cudaError_t e) { return e == cudaSuccess ? 0 : 2000 + e; }

int init_decoder() {
  if (g_codec.handle == nullptr) {
    int rc = status(nvjpegCreateSimple(&g_codec.handle));
    if (rc) return rc;
  }
  if (g_codec.dec == nullptr) {
    return status(nvjpegJpegStateCreate(g_codec.handle, &g_codec.dec));
  }
  return 0;
}

int init_encoder(cudaStream_t stream) {
  int rc = init_decoder();
  if (rc) return rc;
  if (g_codec.enc == nullptr) {
    rc = status(nvjpegEncoderStateCreate(g_codec.handle, &g_codec.enc,
                                         stream));
    if (rc) return rc;
  }
  if (g_codec.params == nullptr) {
    rc = status(nvjpegEncoderParamsCreate(g_codec.handle, &g_codec.params,
                                          stream));
    if (rc) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

int nvj_image_info(const unsigned char* data, size_t len, int* h, int* w) {
  int rc = init_decoder();
  if (rc) return rc;
  int n_comp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT];
  int heights[NVJPEG_MAX_COMPONENT];
  rc = status(nvjpegGetImageInfo(g_codec.handle, data, len, &n_comp, &sub,
                                 widths, heights));
  if (rc) return rc;
  *h = heights[0];
  *w = widths[0];
  return 0;
}

int nvj_decode_rgbi(const unsigned char* data, size_t len, void* out,
                    int pitch, void* stream) {
  int rc = init_decoder();
  if (rc) return rc;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = static_cast<unsigned char*>(out);
  img.pitch[0] = static_cast<size_t>(pitch);
  rc = status(nvjpegDecode(g_codec.handle, g_codec.dec, data, len,
                           NVJPEG_OUTPUT_RGBI, &img,
                           static_cast<cudaStream_t>(stream)));
  if (rc) return rc;
  return cuda_status(cudaGetLastError());
}

int nvj_encode_rgbi(const void* src, int h, int w, int pitch, int quality,
                    unsigned char* out, size_t cap, size_t* out_len,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = init_encoder(s);
  if (rc) return rc;
  rc = status(nvjpegEncoderParamsSetQuality(g_codec.params, quality, s));
  if (rc) return rc;
  rc = status(nvjpegEncoderParamsSetSamplingFactors(g_codec.params,
                                                    NVJPEG_CSS_420, s));
  if (rc) return rc;
  rc = status(nvjpegEncoderParamsSetOptimizedHuffman(g_codec.params, 0, s));
  if (rc) return rc;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = static_cast<unsigned char*>(const_cast<void*>(src));
  img.pitch[0] = static_cast<size_t>(pitch);
  rc = status(nvjpegEncodeImage(g_codec.handle, g_codec.enc, g_codec.params,
                                &img, NVJPEG_INPUT_RGBI, w, h, s));
  if (rc) return rc;
  size_t len = 0;
  rc = status(nvjpegEncodeRetrieveBitstream(g_codec.handle, g_codec.enc,
                                            nullptr, &len, s));
  if (rc) return rc;
  rc = cuda_status(cudaStreamSynchronize(s));
  if (rc) return rc;
  if (len > cap) {
    *out_len = len;
    return 3;
  }
  rc = status(nvjpegEncodeRetrieveBitstream(g_codec.handle, g_codec.enc,
                                            out, &len, s));
  if (rc) return rc;
  rc = cuda_status(cudaStreamSynchronize(s));
  *out_len = len;
  return rc;
}

}  // extern "C"
