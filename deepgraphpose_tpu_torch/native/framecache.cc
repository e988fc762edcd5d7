// Native batch JPEG decoder for the training-frame cache.
//
// Role in the system (SURVEY.md §2c): the reference delegates all decode
// work to external binaries (moviepy/ffmpeg, OpenCV). This rebuild keeps
// the hot training loop off the video container entirely via an in-memory
// JPEG cache (data/video.py FrameCache); this helper turns the remaining
// per-batch JPEG decode cost into a parallel C++ pass: one worker thread
// per slice of the batch, libjpeg(-turbo) decompression straight into the
// caller's preallocated (n, h, w, 3) RGB uint8 buffer — no Python-object
// churn, no extra BGR->RGB pass, no GIL.
//
// Built on demand by deepgraphpose_tpu_torch.native (g++ -O3 -shared
// -ljpeg) into the build directory; loaded via ctypes. Pure C ABI. The
// same source as deepgraphpose_tpu/native/framecache.cc, so both packages
// decode a frame to the same bytes.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG from memory into out (h*w*3, RGB). Returns 0 on success,
// nonzero on decode failure or dimension mismatch.
int decode_one(const uint8_t* buf, size_t size, uint8_t* out, int h, int w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const size_t stride = static_cast<size_t>(w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Decode n JPEGs (bufs[i], sizes[i]) into out, a preallocated
// (n, h, w, 3) C-contiguous RGB uint8 array. Runs on `threads` workers
// (<=0 -> hardware concurrency). Returns the number of failed items.
int fc_decode_batch(const uint8_t** bufs, const size_t* sizes, int n,
                    uint8_t* out, int h, int w, int threads) {
  if (n <= 0) return 0;
  int nt = threads > 0 ? threads
                       : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > n) nt = n;

  const size_t frame_bytes = static_cast<size_t>(h) * w * 3;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (decode_one(bufs[i], sizes[i], out + frame_bytes * i, h, w) != 0) {
        failures.fetch_add(1);
      }
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// Version/ABI probe for the ctypes loader.
int fc_abi_version() { return 1; }

}  // extern "C"
