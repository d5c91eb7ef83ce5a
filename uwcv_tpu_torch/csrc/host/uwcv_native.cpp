// Host-side C++ for the port's folder path (uwcv_tpu_torch/utils/native.py).
//
// The port's own copy of the JAX package's host library: run-length
// encoding, 8-connected component labelling and Moore boundary tracing
// (the same algorithms, so the measurements equal the reference's), plus
// the two image-decoder loops that are sequential byte by byte and would
// take seconds in Python on a 1024x1280 16-bit micrograph: TIFF LZW and
// PNG row unfiltering.  A plain C ABI, loaded with ctypes; built with g++
// at first use by uwcv_tpu_torch/kernels.py.  The numpy versions of every
// entry stay beside the wrappers as their plain versions, for the tests.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// RLE: Fortran-order (column-major) 1-indexed (start, length) pairs.
// mask: H*W uint8 C-order.  out: capacity max_pairs*2 int64.
// Returns the number of pairs written, or -1 if the capacity is exceeded.
// ---------------------------------------------------------------------------
int64_t rle_encode_f(const uint8_t* mask, int64_t h, int64_t w,
                     int64_t* out, int64_t max_pairs) {
  int64_t n_pairs = 0;
  int64_t run_start = -1;
  int64_t pos = 0;  // Fortran linear index
  for (int64_t x = 0; x < w; ++x) {
    for (int64_t y = 0; y < h; ++y, ++pos) {
      const bool v = mask[y * w + x] != 0;
      if (v && run_start < 0) {
        run_start = pos;
      } else if (!v && run_start >= 0) {
        if (n_pairs == max_pairs) return -1;
        out[n_pairs * 2] = run_start + 1;
        out[n_pairs * 2 + 1] = pos - run_start;
        ++n_pairs;
        run_start = -1;
      }
    }
  }
  if (run_start >= 0) {
    if (n_pairs == max_pairs) return -1;
    out[n_pairs * 2] = run_start + 1;
    out[n_pairs * 2 + 1] = pos - run_start;
    ++n_pairs;
  }
  return n_pairs;
}

// ---------------------------------------------------------------------------
// 8-connected component labelling with union-find, two passes.
// labels: H*W int32 output, 0 = background, components numbered 1..n in
// raster order of their first pixel.  Returns n.
// ---------------------------------------------------------------------------
namespace {
struct UnionFind {
  std::vector<int32_t> parent;
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b < a ? a : b] = (b < a ? b : a);
  }
};
}  // namespace

int32_t label_components(const uint8_t* mask, int64_t h, int64_t w,
                         int32_t* labels) {
  UnionFind uf;
  uf.parent.push_back(0);  // background sentinel
  std::memset(labels, 0, sizeof(int32_t) * h * w);
  int32_t next = 1;
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      if (!mask[y * w + x]) continue;
      int32_t neigh[4];
      int n_neigh = 0;
      if (y > 0) {
        if (x > 0 && labels[(y - 1) * w + x - 1]) neigh[n_neigh++] = labels[(y - 1) * w + x - 1];
        if (labels[(y - 1) * w + x]) neigh[n_neigh++] = labels[(y - 1) * w + x];
        if (x + 1 < w && labels[(y - 1) * w + x + 1]) neigh[n_neigh++] = labels[(y - 1) * w + x + 1];
      }
      if (x > 0 && labels[y * w + x - 1]) neigh[n_neigh++] = labels[y * w + x - 1];
      if (n_neigh == 0) {
        uf.parent.push_back(next);
        labels[y * w + x] = next++;
      } else {
        int32_t best = neigh[0];
        for (int i = 1; i < n_neigh; ++i)
          if (neigh[i] < best) best = neigh[i];
        labels[y * w + x] = best;
        for (int i = 0; i < n_neigh; ++i) uf.unite(best, neigh[i]);
      }
    }
  }
  std::vector<int32_t> remap(uf.parent.size(), 0);
  int32_t n_out = 0;
  for (int64_t i = 0; i < h * w; ++i) {
    if (!labels[i]) continue;
    int32_t root = uf.find(labels[i]);
    if (!remap[root]) remap[root] = ++n_out;
    labels[i] = remap[root];
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// Moore-neighbour boundary trace, clockwise, from the first pixel in scan
// order of component `comp` of `labels`.  out_xy: capacity max_pts*2 int32
// (x, y) pairs.  Returns the point count, or -1 if the capacity is exceeded.
// The walk stops when a (pixel, backtrack) state repeats: stopping at the
// start pixel would lose lobes of components pinched diagonally there.
// ---------------------------------------------------------------------------
int64_t moore_trace(const int32_t* labels, int64_t h, int64_t w,
                    int32_t comp, int32_t* out_xy, int64_t max_pts) {
  static const int dx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
  static const int dy[8] = {0, 1, 1, 1, 0, -1, -1, -1};
  int64_t sx = -1, sy = -1;
  for (int64_t y = 0; y < h && sx < 0; ++y)
    for (int64_t x = 0; x < w; ++x)
      if (labels[y * w + x] == comp) { sx = x; sy = y; break; }
  if (sx < 0) return 0;

  auto at = [&](int64_t x, int64_t y) -> bool {
    return x >= 0 && y >= 0 && x < w && y < h && labels[y * w + x] == comp;
  };

  int64_t cx = sx, cy = sy;
  int prev_dir = 4;  // West: the start pixel was entered scanning rightwards
  if (max_pts < 1) return -1;
  out_xy[0] = (int32_t)cx;
  out_xy[1] = (int32_t)cy;
  int64_t n = 1;
  std::vector<uint8_t> seen((size_t)(h * w), 0);  // one bit per direction
  seen[(size_t)(cy * w + cx)] = (uint8_t)(1u << prev_dir);
  const int64_t hard_cap = 8 * h * w;
  for (int64_t guard = 0; guard < hard_cap; ++guard) {
    int found = -1;
    for (int i = 0; i < 8; ++i) {
      const int d = (prev_dir + 1 + i) % 8;
      if (at(cx + dx[d], cy + dy[d])) { found = d; break; }
    }
    if (found < 0) break;  // isolated pixel
    prev_dir = (found + 4) % 8;
    cx += dx[found];
    cy += dy[found];
    uint8_t& bits = seen[(size_t)(cy * w + cx)];
    const uint8_t bit = (uint8_t)(1u << prev_dir);
    if (bits & bit) break;  // the cycle is closed
    bits |= bit;
    if (n == max_pts) return -1;
    out_xy[n * 2] = (int32_t)cx;
    out_xy[n * 2 + 1] = (int32_t)cy;
    ++n;
  }
  return n;
}

// ---------------------------------------------------------------------------
// TIFF LZW (compression 5): MSB-first codes of 9 to 12 bits, Clear = 256,
// EndOfInformation = 257, and TIFF's "early change" (the code width grows
// one code before the table fills it).  Decodes one strip of n_in bytes
// into out (capacity n_out; a longer stream is cut at n_out).
// Returns the number of bytes written, or -1 for a malformed stream.
// ---------------------------------------------------------------------------
int64_t tiff_lzw_decode(const uint8_t* in, int64_t n_in, uint8_t* out,
                        int64_t n_out) {
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> length(4096);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  uint8_t stack[4096];
  int next = 258, width = 9, old = -1;
  uint32_t buf = 0;
  int nbits = 0;
  int64_t ip = 0, op = 0;
  // emit the string of `code`, cut at the output's end
  auto emit = [&](int code) {
    int len = length[code];
    for (int k = len - 1, c = code; k >= 0; --k, c = prefix[c])
      stack[k] = suffix[c];
    int64_t take = len < n_out - op ? len : n_out - op;
    if (take > 0) std::memcpy(out + op, stack, (size_t)take);
    op += take;
  };
  while (op < n_out) {
    while (nbits < width) {
      if (ip >= n_in) return op;  // the stream ends without EOI
      buf = (buf << 8) | in[ip++];
      nbits += 8;
    }
    const int code = (int)((buf >> (nbits - width)) & ((1u << width) - 1));
    nbits -= width;
    if (code == 257) break;
    if (code == 256) {
      next = 258;
      width = 9;
      old = -1;
      continue;
    }
    if (old < 0) {  // the first code after a Clear is a literal
      if (code > 255) return -1;
      emit(code);
      old = code;
      continue;
    }
    uint8_t head;
    if (code < next) {
      emit(code);
      head = first[code];
    } else if (code == next) {  // the KwKwK case: old's string + its head
      head = first[old];
      if (next < 4096) {
        prefix[next] = (uint16_t)old;
        suffix[next] = head;
        first[next] = first[old];
        length[next] = (uint16_t)(length[old] + 1);
      }
      emit(code);
      old = code;
      if (++next >= (1 << width) - 1 && width < 12) ++width;
      continue;
    } else {
      return -1;
    }
    if (next < 4096) {
      prefix[next] = (uint16_t)old;
      suffix[next] = head;
      first[next] = first[old];
      length[next] = (uint16_t)(length[old] + 1);
      ++next;
    }
    old = code;
    if (next >= (1 << width) - 1 && width < 12) ++width;
  }
  return op;
}

// ---------------------------------------------------------------------------
// PNG row unfiltering (filter types 0-4 of the PNG specification).
// data: h rows of 1 + stride bytes (the filter byte, then the filtered
// row); bpp: bytes per complete pixel, at least 1.  out: h*stride bytes.
// Returns 0, or -1 at an unknown filter type.
// ---------------------------------------------------------------------------
int32_t png_unfilter(const uint8_t* data, int64_t h, int64_t stride,
                     int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = data + y * (stride + 1);
    const int filter = src[0];
    ++src;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y > 0 ? cur - stride : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(cur, src, (size_t)stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

}  // extern "C"
