// Baseline JPEG writer for the synthetic dataset on a host with libjpeg.
//
// libjpeg's compress API with its defaults (baseline, 4:2:0 chroma, the
// islow DCT) and the quality set with force_baseline, the settings PIL's
// Image.save(..., quality=q) passes to the same library.  The card's
// route is csrc/nvjpeg_codec.cu.
//
// C ABI (ctypes):
//   int write_jpeg_rgb(const char* path, const unsigned char* rgb,
//                      int h, int w, int quality);
// rgb is h * w * 3 interleaved.  Returns 0, 1 when the file cannot be
// opened, 2 when libjpeg reports an error.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC jpeg_write.cpp \
//            -ljpeg -o libjpeg_write.so

#include <csetjmp>
#include <cstdio>

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

}  // namespace

extern "C" {

int write_jpeg_rgb(const char* path, const unsigned char* rgb, int h, int w,
                   int quality) {
  FILE* volatile f = std::fopen(path, "wb");
  if (!f) return 1;
  jpeg_compress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = on_jpeg_error;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  std::fclose(f);
  return 0;
}

}  // extern "C"
