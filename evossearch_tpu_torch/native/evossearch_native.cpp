// evossearch_tpu_torch native runtime components (C++17, CPython C API):
// the package's own copy of the JAX package's host extension, built at
// first use by evossearch_tpu_torch/native/__init__.py.
//
//   topk(emb_buffer, n, d, query, k)       exact inner-product top-k over a
//                                          float32 row-major matrix (zero-
//                                          copy over np.memmap), threaded,
//                                          (score desc, index asc) ties —
//                                          the host scan of corpora over
//                                          the device budget
//   topk_bf16(bits_buffer, n, d, q, k)     the same over bfloat16 bit
//                                          patterns (uint16), widened in
//                                          the scan loop
//   decode_jpeg(bytes, min_short_side)     libjpeg decode with DCT scaling
//                                          (decodes at 1/8..8/8 scale, the
//                                          cheapest scale whose short side
//                                          still covers the target) -> RGB8
//   decode_jpeg_batch([...], min, threads) threaded batch decode, GIL
//                                          released
//   decode_jpeg_planar(bytes, min)         same decode but emitting planar
//                                          Y + 2x2-box-subsampled Cb/Cr
//                                          (1.5 B/px vs RGB's 3 — halves
//                                          the host->device upload); color
//                                          conversion and chroma resampling
//                                          run on the device
//                                          (preprocess/pipeline.py)
//   decode_jpeg_planar_batch([...], ...)   threaded batch planar decode
//
// Built with -DEVS_NO_JPEG where the libjpeg headers are missing: the one
// #ifndef block below then drops the four decode entry points, and the
// module holds the scanner alone.
//
// Build: g++ -O3 -march=native -fPIC -shared -std=c++17 [-DEVS_NO_JPEG]
//        -I<python include> evossearch_native.cpp [-ljpeg] -lpthread

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- top-k

struct Hit {
  float score;
  int64_t idx;
};

// "a ranks better than b": higher score, then lower index.
inline bool better(const Hit& a, const Hit& b) {
  return a.score > b.score || (a.score == b.score && a.idx < b.idx);
}

// Binary min-heap on "better" (worst element at the root) of fixed capacity.
class TopK {
 public:
  explicit TopK(size_t k) : k_(k) { heap_.reserve(k); }

  inline void push(float score, int64_t idx) {
    Hit h{score, idx};
    if (heap_.size() < k_) {
      heap_.push_back(h);
      std::push_heap(heap_.begin(), heap_.end(), better);
    } else if (better(h, heap_.front())) {
      std::pop_heap(heap_.begin(), heap_.end(), better);
      heap_.back() = h;
      std::push_heap(heap_.begin(), heap_.end(), better);
    }
  }

  inline float worst() const {
    return heap_.size() < k_ ? -INFINITY : heap_.front().score;
  }

  std::vector<Hit> sorted() {
    std::vector<Hit> out = heap_;
    std::sort(out.begin(), out.end(), better);
    return out;
  }

 private:
  size_t k_;
  std::vector<Hit> heap_;
};

void scan_range(const float* emb, int64_t d, int64_t begin, int64_t end,
                const float* query, TopK* top) {
  for (int64_t row = begin; row < end; ++row) {
    const float* v = emb + row * d;
    float acc = 0.f;
    // Plain loop: g++ -O3 auto-vectorizes this into FMA lanes.
    for (int64_t j = 0; j < d; ++j) acc += v[j] * query[j];
    if (acc > top->worst()) top->push(acc, row);
  }
}

// bfloat16 = the top 16 bits of an f32; widening is a shift, so the scan
// streams the mmap'd bf16 shard directly — no f32 copy of the corpus
// (the store defaults to bf16 and a per-query O(N*d) conversion would
// defeat the zero-copy host path).
inline float bf16_to_f32(uint16_t b) {
  uint32_t u = (uint32_t)b << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

void scan_range_bf16(const uint16_t* emb, int64_t d, int64_t begin,
                     int64_t end, const float* query, TopK* top) {
  for (int64_t row = begin; row < end; ++row) {
    const uint16_t* v = emb + row * d;
    float acc = 0.f;
    for (int64_t j = 0; j < d; ++j) acc += bf16_to_f32(v[j]) * query[j];
    if (acc > top->worst()) top->push(acc, row);
  }
}

PyObject* topk_impl(PyObject* args, bool bf16) {
  Py_buffer emb_buf, q_buf;
  Py_ssize_t n, d;
  int k;
  if (!PyArg_ParseTuple(args, "y*nny*i", &emb_buf, &n, &d, &q_buf, &k)) {
    return nullptr;
  }
  size_t elem = bf16 ? sizeof(uint16_t) : sizeof(float);
  if ((Py_ssize_t)(n * d * elem) > emb_buf.len ||
      (Py_ssize_t)(d * sizeof(float)) > q_buf.len || k < 0) {
    PyBuffer_Release(&emb_buf);
    PyBuffer_Release(&q_buf);
    PyErr_SetString(PyExc_ValueError, "buffer too small for given n/d/k");
    return nullptr;
  }
  const float* emb = static_cast<const float*>(emb_buf.buf);
  const uint16_t* emb16 = static_cast<const uint16_t*>(emb_buf.buf);
  const float* query = static_cast<const float*>(q_buf.buf);
  if (k > n) k = (int)n;

  unsigned nthreads = std::max(1u, std::thread::hardware_concurrency());
  nthreads = std::min<unsigned>(nthreads, 16);
  if (n < 65536) nthreads = 1;

  std::vector<TopK> parts;
  parts.reserve(nthreads);
  for (unsigned t = 0; t < nthreads; ++t) parts.emplace_back((size_t)k);

  Py_BEGIN_ALLOW_THREADS;
  if (nthreads == 1) {
    if (bf16) {
      scan_range_bf16(emb16, d, 0, n, query, &parts[0]);
    } else {
      scan_range(emb, d, 0, n, query, &parts[0]);
    }
  } else {
    std::vector<std::thread> threads;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (unsigned t = 0; t < nthreads; ++t) {
      int64_t begin = (int64_t)t * chunk;
      int64_t end = std::min<int64_t>(begin + chunk, n);
      if (begin >= end) break;
      if (bf16) {
        threads.emplace_back(scan_range_bf16, emb16, d, begin, end, query,
                             &parts[t]);
      } else {
        threads.emplace_back(scan_range, emb, d, begin, end, query,
                             &parts[t]);
      }
    }
    for (auto& th : threads) th.join();
  }
  Py_END_ALLOW_THREADS;

  TopK merged((size_t)k);
  for (auto& p : parts) {
    for (const Hit& h : p.sorted()) merged.push(h.score, h.idx);
  }
  std::vector<Hit> hits = merged.sorted();

  PyBuffer_Release(&emb_buf);
  PyBuffer_Release(&q_buf);

  PyObject* scores = PyList_New((Py_ssize_t)hits.size());
  PyObject* indices = PyList_New((Py_ssize_t)hits.size());
  for (size_t i = 0; i < hits.size(); ++i) {
    PyList_SET_ITEM(scores, i, PyFloat_FromDouble(hits[i].score));
    PyList_SET_ITEM(indices, i, PyLong_FromLongLong(hits[i].idx));
  }
  PyObject* out = PyTuple_Pack(2, scores, indices);
  Py_DECREF(scores);
  Py_DECREF(indices);
  return out;
}

PyObject* py_topk(PyObject*, PyObject* args) {
  return topk_impl(args, /*bf16=*/false);
}

PyObject* py_topk_bf16(PyObject*, PyObject* args) {
  return topk_impl(args, /*bf16=*/true);
}

}  // namespace

#ifndef EVS_NO_JPEG
#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------- jpeg

struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
  char msg[JMSG_LENGTH_MAX];
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegError*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->msg);
  longjmp(err->jump, 1);
}

struct DecodedImage {
  std::vector<uint8_t> rgb;
  int height = 0;
  int width = 0;
  bool ok = false;
  char msg[JMSG_LENGTH_MAX] = {0};
};

// DCT scaling: pick the smallest num/8 scale whose short side still
// reaches min_short_side (0 = always full size). This is the decode-side
// half of the preprocess resize — an 8x cheaper decode for big photos.
void set_dct_scale(jpeg_decompress_struct* cinfo, int min_short_side) {
  if (min_short_side <= 0) return;
  unsigned short_side = std::min(cinfo->image_width, cinfo->image_height);
  unsigned num = 8;
  for (unsigned cand = 1; cand <= 8; ++cand) {
    if (short_side * cand / 8 >= (unsigned)min_short_side) {
      num = cand;
      break;
    }
  }
  cinfo->scale_num = num;
  cinfo->scale_denom = 8;
}

DecodedImage decode_one(const uint8_t* data, size_t len, int min_short_side) {
  DecodedImage out;
  jpeg_decompress_struct cinfo;
  JpegError err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_error_exit;
  if (setjmp(err.jump)) {
    std::snprintf(out.msg, sizeof(out.msg), "%s", err.msg);
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  set_dct_scale(&cinfo, min_short_side);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  out.width = (int)cinfo.output_width;
  out.height = (int)cinfo.output_height;
  size_t stride = (size_t)out.width * cinfo.output_components;
  out.rgb.resize((size_t)out.height * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowptr = out.rgb.data() + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out.ok = true;
  return out;
}

// Planar decode: Y at output resolution + Cb/Cr box-subsampled 2x2.
//
// The decode runs with out_color_space=JCS_YCbCr (libjpeg skips its
// YCbCr->RGB conversion entirely) and do_fancy_upsampling=FALSE. For a
// full-scale 4:2:0 decode, non-fancy h2v2 upsampling replicates each
// stored chroma sample into an aligned 2x2 block, so the 2x2 box average
// below recovers the file's ORIGINAL chroma samples bit-exactly; at DCT
// scales < 8/8 the chroma plane already sits at output resolution (the
// IDCT scales each component independently) and the box average is an
// honest 2x downsample. Either way the device resampler sees chroma on
// the standard centered 4:2:0 grid (sample (i,j) covering output pixels
// (2i..2i+1, 2j..2j+1)).
struct PlanarImage {
  std::vector<uint8_t> y, cb, cr;
  int height = 0, width = 0, ch = 0, cw = 0;
  bool planar = false;  // false + ok -> rgb fallback result below
  DecodedImage rgb;     // used when the source can't ship planar YCbCr
  bool ok = false;
  char msg[JMSG_LENGTH_MAX] = {0};
};

PlanarImage decode_one_planar(const uint8_t* data, size_t len,
                              int min_short_side) {
  PlanarImage out;
  jpeg_decompress_struct cinfo;
  JpegError err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_error_exit;
  if (setjmp(err.jump)) {
    std::snprintf(out.msg, sizeof(out.msg), "%s", err.msg);
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.jpeg_color_space != JCS_YCbCr || cinfo.num_components != 3) {
    // grayscale / CMYK / odd files: RGB path (caller handles both shapes)
    jpeg_destroy_decompress(&cinfo);
    out.rgb = decode_one(data, len, min_short_side);
    out.ok = out.rgb.ok;
    if (!out.ok) std::snprintf(out.msg, sizeof(out.msg), "%s", out.rgb.msg);
    return out;
  }
  set_dct_scale(&cinfo, min_short_side);
  if (cinfo.comp_info[0].h_samp_factor == 2 &&
      cinfo.comp_info[0].v_samp_factor == 2 &&
      cinfo.comp_info[1].h_samp_factor == 1 &&
      cinfo.comp_info[1].v_samp_factor == 1 &&
      cinfo.comp_info[2].h_samp_factor == 1 &&
      cinfo.comp_info[2].v_samp_factor == 1) {
    // 4:2:0 (the overwhelmingly common photo layout): raw-coefficient
    // output. jpeg_read_raw_data hands each component back at its own
    // IDCT resolution — libjpeg's chroma upsample, the interleaved
    // YCbCr buffer, and the host deinterleave pass all disappear
    // (measured on the JAX package's copy of this code: +17% on 480x640
    // q85 noise JPEGs at min_short_side=224, +136% on full-scale
    // photo-like JPEGs). Bit-identical to the interleaved path below
    // (verified across odd sizes, DCT scales, progressive, odd block
    // heights):
    //  * full scale: chroma arrives exactly on the (ch, cw) target grid
    //    (replicate-upsample then 2x2 box average is the identity);
    //  * DCT-scaled: chroma IDCTs at twice Y's DCT size, arriving at Y
    //    resolution, and the same 2x2 box average the interleaved path
    //    applies brings it to the target grid.
    cinfo.raw_data_out = TRUE;
    jpeg_start_decompress(&cinfo);
    const int w = (int)cinfo.output_width;
    const int h = (int)cinfo.output_height;
    out.width = w;
    out.height = h;
    out.cw = (w + 1) / 2;
    out.ch = (h + 1) / 2;
    const int ydct = cinfo.comp_info[0].DCT_scaled_size;
    const int cdct = cinfo.comp_info[1].DCT_scaled_size;
    const bool chroma_at_y_res = 2 * ydct <= cdct;
    const int yw = (int)cinfo.comp_info[0].width_in_blocks * ydct;
    const int cwp = (int)cinfo.comp_info[1].width_in_blocks * cdct;
    // iMCU-aligned plane heights: the bitstream carries dummy padding
    // blocks to the iMCU boundary and read_raw_data delivers their rows
    // too — undersized buffers would force overwriting real rows.
    const int yh = (int)cinfo.total_iMCU_rows * 2 * ydct;
    const int chp = (int)cinfo.total_iMCU_rows * cdct;
    std::vector<uint8_t> ybuf((size_t)yh * yw);
    std::vector<uint8_t> cbbuf((size_t)chp * cwp);
    std::vector<uint8_t> crbuf((size_t)chp * cwp);
    const int mcu_rows = 2 * ydct;  // max_v_samp * min_DCT_scaled_size
    JSAMPROW yrows[32], cbrows[16], crrows[16];
    JSAMPARRAY comp_rows[3] = {yrows, cbrows, crrows};
    size_t done_y = 0, done_c = 0;
    while (cinfo.output_scanline < cinfo.output_height) {
      for (int r = 0; r < mcu_rows; ++r) {
        yrows[r] = ybuf.data() + (done_y + (size_t)r) * yw;
      }
      for (int r = 0; r < cdct; ++r) {
        cbrows[r] = cbbuf.data() + (done_c + (size_t)r) * cwp;
        crrows[r] = crbuf.data() + (done_c + (size_t)r) * cwp;
      }
      if (!jpeg_read_raw_data(&cinfo, comp_rows, (JDIMENSION)mcu_rows)) {
        break;
      }
      done_y += (size_t)mcu_rows;
      done_c += (size_t)cdct;
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    out.y.resize((size_t)h * w);
    for (int i = 0; i < h; ++i) {
      std::memcpy(out.y.data() + (size_t)i * w,
                  ybuf.data() + (size_t)i * yw, (size_t)w);
    }
    out.cb.resize((size_t)out.ch * out.cw);
    out.cr.resize((size_t)out.ch * out.cw);
    if (chroma_at_y_res) {
      // scaled decode: 2x2 box average from the (h, w)-resolution chroma
      // planes — the same math as the interleaved path, on planar data
      for (int i = 0; i < h; i += 2) {
        const uint8_t* b0cb = cbbuf.data() + (size_t)i * cwp;
        const uint8_t* b1cb = (i + 1 < h) ? b0cb + cwp : b0cb;
        const uint8_t* b0cr = crbuf.data() + (size_t)i * cwp;
        const uint8_t* b1cr = (i + 1 < h) ? b0cr + cwp : b0cr;
        uint8_t* cbd = out.cb.data() + (size_t)(i / 2) * out.cw;
        uint8_t* crd = out.cr.data() + (size_t)(i / 2) * out.cw;
        for (int j = 0; j < w; j += 2) {
          const int j1 = (j + 1 < w) ? j + 1 : j;
          const int cb = b0cb[j] + b0cb[j1] + b1cb[j] + b1cb[j1];
          const int cr = b0cr[j] + b0cr[j1] + b1cr[j] + b1cr[j1];
          cbd[j / 2] = (uint8_t)((cb + 2) >> 2);
          crd[j / 2] = (uint8_t)((cr + 2) >> 2);
        }
      }
    } else {
      // full scale: chroma is already on the target grid
      for (int i = 0; i < out.ch; ++i) {
        std::memcpy(out.cb.data() + (size_t)i * out.cw,
                    cbbuf.data() + (size_t)i * cwp, (size_t)out.cw);
        std::memcpy(out.cr.data() + (size_t)i * out.cw,
                    crbuf.data() + (size_t)i * cwp, (size_t)out.cw);
      }
    }
    out.planar = true;
    out.ok = true;
    return out;
  }
  cinfo.out_color_space = JCS_YCbCr;
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_start_decompress(&cinfo);

  const int w = (int)cinfo.output_width;
  const int h = (int)cinfo.output_height;
  out.width = w;
  out.height = h;
  out.cw = (w + 1) / 2;
  out.ch = (h + 1) / 2;
  const size_t stride = (size_t)w * cinfo.output_components;
  std::vector<uint8_t> inter((size_t)h * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowptr = inter.data() + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  out.y.resize((size_t)h * w);
  out.cb.resize((size_t)out.ch * out.cw);
  out.cr.resize((size_t)out.ch * out.cw);
  for (int i = 0; i < h; i += 2) {
    const uint8_t* r0 = inter.data() + (size_t)i * stride;
    // odd height: duplicate the last row (the 2x2 average then equals the
    // plain 1x2 average of the single available row)
    const uint8_t* r1 = (i + 1 < h) ? r0 + stride : r0;
    uint8_t* y0 = out.y.data() + (size_t)i * w;
    for (int x = 0; x < w; ++x) y0[x] = r0[3 * x];
    if (i + 1 < h) {
      uint8_t* y1 = y0 + w;
      for (int x = 0; x < w; ++x) y1[x] = r1[3 * x];
    }
    uint8_t* cbd = out.cb.data() + (size_t)(i / 2) * out.cw;
    uint8_t* crd = out.cr.data() + (size_t)(i / 2) * out.cw;
    for (int j = 0; j < w; j += 2) {
      const int j1 = (j + 1 < w) ? j + 1 : j;  // odd width: duplicate col
      const int cb = r0[3 * j + 1] + r0[3 * j1 + 1] + r1[3 * j + 1] +
                     r1[3 * j1 + 1];
      const int cr = r0[3 * j + 2] + r0[3 * j1 + 2] + r1[3 * j + 2] +
                     r1[3 * j1 + 2];
      cbd[j / 2] = (uint8_t)((cb + 2) >> 2);
      crd[j / 2] = (uint8_t)((cr + 2) >> 2);
    }
  }
  out.planar = true;
  out.ok = true;
  return out;
}

PyObject* decoded_to_py(const DecodedImage& img) {
  if (!img.ok) {
    PyErr_Format(PyExc_ValueError, "JPEG decode failed: %s", img.msg);
    return nullptr;
  }
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(img.rgb.data()),
      (Py_ssize_t)img.rgb.size());
  if (!bytes) return nullptr;
  PyObject* out = Py_BuildValue("iiN", img.height, img.width, bytes);
  return out;
}

PyObject* planar_to_py(const PlanarImage& img) {
  if (!img.ok) {
    PyErr_Format(PyExc_ValueError, "JPEG decode failed: %s", img.msg);
    return nullptr;
  }
  if (!img.planar) return decoded_to_py(img.rgb);  // 3-tuple (h, w, rgb)
  PyObject* y = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(img.y.data()), (Py_ssize_t)img.y.size());
  PyObject* cb = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(img.cb.data()), (Py_ssize_t)img.cb.size());
  PyObject* cr = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(img.cr.data()), (Py_ssize_t)img.cr.size());
  if (!y || !cb || !cr) {
    Py_XDECREF(y);
    Py_XDECREF(cb);
    Py_XDECREF(cr);
    return nullptr;
  }
  return Py_BuildValue("iiiiNNN", img.height, img.width, img.ch, img.cw, y,
                       cb, cr);
}

PyObject* py_decode_jpeg_planar(PyObject*, PyObject* args) {
  Py_buffer buf;
  int min_short_side = 0;
  if (!PyArg_ParseTuple(args, "y*|i", &buf, &min_short_side)) return nullptr;
  PlanarImage img;
  Py_BEGIN_ALLOW_THREADS;
  img = decode_one_planar(static_cast<const uint8_t*>(buf.buf),
                          (size_t)buf.len, min_short_side);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  return planar_to_py(img);
}

// Shared batch harness for the two decoders: list-of-bytes parsing,
// thread-count clamping, the atomic work-queue workers, and the per-item
// None-on-failure marshaling (caller skips, reference oldapp.py:79-80).
// One home so a harness fix (input validation, error propagation) cannot
// land in one entry point and silently miss the other.
template <typename Img, Img (*DecodeFn)(const uint8_t*, size_t, int),
          PyObject* (*ToPy)(const Img&)>
PyObject* decode_batch_impl(PyObject* args) {
  PyObject* list;
  int min_short_side = 0;
  int nthreads = 0;
  if (!PyArg_ParseTuple(args, "O|ii", &list, &min_short_side, &nthreads)) {
    return nullptr;
  }
  if (!PyList_Check(list)) {
    PyErr_SetString(PyExc_TypeError, "expected a list of bytes");
    return nullptr;
  }
  Py_ssize_t count = PyList_GET_SIZE(list);
  std::vector<std::pair<const uint8_t*, size_t>> inputs((size_t)count);
  for (Py_ssize_t i = 0; i < count; ++i) {
    PyObject* item = PyList_GET_ITEM(list, i);
    char* data;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(item, &data, &len) != 0) return nullptr;
    inputs[(size_t)i] = {reinterpret_cast<const uint8_t*>(data), (size_t)len};
  }
  if (nthreads <= 0) {
    nthreads = (int)std::max(1u, std::thread::hardware_concurrency());
  }
  nthreads = std::min<int>(nthreads, 16);

  std::vector<Img> results((size_t)count);
  Py_BEGIN_ALLOW_THREADS;
  std::atomic<Py_ssize_t> next(0);
  auto worker = [&]() {
    while (true) {
      Py_ssize_t i = next.fetch_add(1);
      if (i >= count) break;
      results[(size_t)i] = DecodeFn(inputs[(size_t)i].first,
                                    inputs[(size_t)i].second,
                                    min_short_side);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  Py_END_ALLOW_THREADS;

  PyObject* out = PyList_New(count);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < count; ++i) {
    const Img& img = results[(size_t)i];
    PyObject* item;
    if (img.ok) {
      item = ToPy(img);
      if (!item) {
        Py_DECREF(out);
        return nullptr;
      }
    } else {
      // per-image failure -> None (caller skips, reference oldapp.py:79-80)
      item = Py_None;
      Py_INCREF(item);
    }
    PyList_SET_ITEM(out, i, item);
  }
  return out;
}

PyObject* py_decode_jpeg_planar_batch(PyObject*, PyObject* args) {
  return decode_batch_impl<PlanarImage, decode_one_planar, planar_to_py>(args);
}

PyObject* py_decode_jpeg(PyObject*, PyObject* args) {
  Py_buffer buf;
  int min_short_side = 0;
  if (!PyArg_ParseTuple(args, "y*|i", &buf, &min_short_side)) return nullptr;
  DecodedImage img;
  Py_BEGIN_ALLOW_THREADS;
  img = decode_one(static_cast<const uint8_t*>(buf.buf), (size_t)buf.len,
                   min_short_side);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  return decoded_to_py(img);
}

PyObject* py_decode_jpeg_batch(PyObject*, PyObject* args) {
  return decode_batch_impl<DecodedImage, decode_one, decoded_to_py>(args);
}

}  // namespace

// the decode entry points of the method table below
#define EVS_DECODE_METHODS                                                   \
  {"decode_jpeg", py_decode_jpeg, METH_VARARGS,                              \
   "decode_jpeg(data, min_short_side=0) -> (h, w, rgb_bytes)"},              \
  {"decode_jpeg_batch", py_decode_jpeg_batch, METH_VARARGS,                  \
   "decode_jpeg_batch(list_of_bytes, min_short_side=0, threads=0) -> "       \
   "list[(h, w, rgb_bytes) | None]"},                                        \
  {"decode_jpeg_planar", py_decode_jpeg_planar, METH_VARARGS,                \
   "decode_jpeg_planar(data, min_short_side=0) -> "                          \
   "(h, w, ch, cw, y, cb, cr) | (h, w, rgb_bytes) for non-YCbCr sources"},   \
  {"decode_jpeg_planar_batch", py_decode_jpeg_planar_batch, METH_VARARGS,    \
   "decode_jpeg_planar_batch(list_of_bytes, min_short_side=0, threads=0) "   \
   "-> list[(h, w, ch, cw, y, cb, cr) | (h, w, rgb_bytes) | None]"},
#else
#define EVS_DECODE_METHODS
#endif  // EVS_NO_JPEG

namespace {

PyMethodDef methods[] = {
    {"topk", py_topk, METH_VARARGS,
     "topk(emb_buffer, n, d, query_buffer, k) -> (scores, indices)"},
    {"topk_bf16", py_topk_bf16, METH_VARARGS,
     "topk_bf16(bf16_emb_buffer, n, d, f32_query_buffer, k) -> "
     "(scores, indices)"},
    EVS_DECODE_METHODS
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native",
    "evossearch_tpu_torch native runtime (exact scan + JPEG decode)", -1,
    methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&moduledef); }
