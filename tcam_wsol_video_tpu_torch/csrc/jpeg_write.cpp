// Baseline JPEG writer for the synthetic dataset on a host with libjpeg.
//
// libjpeg's compress API with its defaults (baseline, 4:2:0 chroma, the
// islow DCT) and the quality set with force_baseline, the settings PIL's
// Image.save(..., quality=q) passes to the same library.  The card's
// route is csrc/nvjpeg_codec.cu.
//
// C ABI (ctypes):
//   int encode_jpeg_rgb(const unsigned char* rgb, int h, int w, int quality,
//                       unsigned char* out, size_t cap, size_t* n);
// rgb is h * w * 3 interleaved.  Returns 0, 1 when the JPEG's *n bytes
// exceed cap, 2 when libjpeg reports an error.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC jpeg_write.cpp \
//            -ljpeg -o libjpeg_write.so

#include <csetjmp>
#include <cstdio>  // jpeglib.h needs FILE
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void on_jpeg_error(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void compress_rows(jpeg_compress_struct* cinfo, const unsigned char* rgb,
                   int h, int w, int quality) {
  cinfo->image_width = w;
  cinfo->image_height = h;
  cinfo->input_components = 3;
  cinfo->in_color_space = JCS_RGB;
  jpeg_set_defaults(cinfo);
  jpeg_set_quality(cinfo, quality, TRUE);
  jpeg_start_compress(cinfo, TRUE);
  while (cinfo->next_scanline < cinfo->image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + static_cast<size_t>(cinfo->next_scanline) * w * 3);
    jpeg_write_scanlines(cinfo, &row, 1);
  }
  jpeg_finish_compress(cinfo);
}

}  // namespace

extern "C" {

int encode_jpeg_rgb(const unsigned char* rgb, int h, int w, int quality,
                    unsigned char* out, size_t cap, size_t* n) {
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  // libjpeg grows this buffer; its address is taken, so it survives the
  // longjmp of an error
  unsigned char* buf = nullptr;
  unsigned long size = 0;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = on_jpeg_error;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    std::free(buf);
    return 2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &size);
  compress_rows(&cinfo, rgb, h, w, quality);
  jpeg_destroy_compress(&cinfo);
  *n = size;
  const int rc = size > cap ? 1 : 0;
  if (rc == 0) std::memcpy(out, buf, size);
  std::free(buf);
  return rc;
}

}  // extern "C"
