// Native host-side runtime for hpccg_tpu (the counterpart of the reference's
// C++ host tier: read_HPC_row.cpp's parser and generate_matrix.cpp's
// assembly loop). Compiled to libhpccg_host.so and loaded via ctypes
// (hpccg_tpu/native.py). The device compute path stays JAX; this library
// covers the host-bound work: file tokenization, ELL assembly, serialization,
// RCM reordering.
//
// Written from the format/problem *specification* in SURVEY.md — not a copy
// of the reference sources.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Fast numeric tokenizer: parse all whitespace-separated numbers in a file.
// Returns the token count, or -1 on IO error. If out != nullptr it must have
// room for cap tokens; parsing stops at cap.
// ---------------------------------------------------------------------------
int64_t hpccg_tokenize_file(const char* path, double* out, int64_t cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return -1;
  }
  char* buf = static_cast<char*>(std::malloc(size + 1));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  size_t rd = std::fread(buf, 1, size, f);
  std::fclose(f);
  buf[rd] = '\0';

  int64_t n = 0;
  char* p = buf;
  char* end = buf + rd;
  while (p < end) {
    char* next = nullptr;
    errno = 0;
    double v = std::strtod(p, &next);
    if (next == p) {
      ++p;  // skip non-numeric byte
      continue;
    }
    if (out) {
      if (n >= cap) break;
      out[n] = v;
    }
    ++n;
    p = next;
  }
  std::free(buf);
  return n;
}

// ---------------------------------------------------------------------------
// Streaming range tokenizer: parse numeric tokens [skip, skip+cap) of a file
// WITHOUT loading the file (fixed 1 MiB window with a carry for tokens split
// across window edges). This is the bounded-memory distributed-loading tier:
// the reference's read_HPC_row reads only each rank's row block
// (read_HPC_row.cpp:255-293); a multi-device file must never materialize
// whole per process. Returns tokens written (< cap means the file ended), or -1 on
// IO error, -2 on a token longer than the window (not a real text format).
// ---------------------------------------------------------------------------
int64_t hpccg_tokenize_range(const char* path, int64_t skip, double* out,
                             int64_t cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const size_t CH = 1 << 20;
  char* buf = static_cast<char*>(std::malloc(CH + 1));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  size_t have = 0;
  int64_t to_skip = skip;
  int64_t emitted = 0;
  bool eof = false;
  while (emitted < cap || out == nullptr) {
    if (!eof) {
      size_t rd = std::fread(buf + have, 1, CH - have, f);
      if (rd < CH - have) eof = true;
      have += rd;
    }
    buf[have] = '\0';
    char* p = buf;
    char* end = buf + have;
    while (p < end && emitted < cap) {
      char* next = nullptr;
      errno = 0;
      double v = std::strtod(p, &next);
      if (next == p) {
        ++p;  // non-numeric byte
        continue;
      }
      if (next == end && !eof) break;  // token may continue in next window
      if (to_skip > 0) {
        --to_skip;
      } else {
        if (out) out[emitted] = v;
        ++emitted;
      }
      p = next;
    }
    if (emitted >= cap) break;
    size_t tail = static_cast<size_t>(end - p);
    if (tail == have && have == CH) {  // no progress: token wider than window
      std::free(buf);
      std::fclose(f);
      return -2;
    }
    std::memmove(buf, p, tail);
    have = tail;
    if (eof && tail == 0) break;
    if (eof && tail == have && p == buf) break;  // nothing parseable left
  }
  std::free(buf);
  std::fclose(f);
  return emitted;
}

// ---------------------------------------------------------------------------
// Chained-cursor variant of the range tokenizer: start parsing at an
// absolute BYTE offset, skip `skip` tokens, emit up to `cap`, and (when
// end_byte != nullptr) report the byte offset just past the last consumed
// token — the next call resumes there with zero re-parsing. This turns the
// distributed loader's per-device reads into ONE forward pass per file
// section instead of O(devices) token-skip re-parses from byte 0
// (tokens are whitespace-delimited, so resuming at a token boundary is
// safe). Returns tokens written, -1 on IO error, -2 on an over-wide token.
// ---------------------------------------------------------------------------
int64_t hpccg_tokenize_range_at(const char* path, int64_t start_byte,
                                int64_t skip, double* out, int64_t cap,
                                int64_t* end_byte) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (start_byte > 0 && std::fseek(f, (long)start_byte, SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  const size_t CH = 1 << 20;
  char* buf = static_cast<char*>(std::malloc(CH + 1));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  size_t have = 0;
  int64_t base = start_byte;  // absolute file offset of buf[0]
  int64_t last_end = start_byte;
  int64_t to_skip = skip;
  int64_t emitted = 0;
  bool eof = false;
  // skip-only calls (cap == 0) still consume their tokens so end_byte
  // lands after the skipped section
  while (to_skip > 0 || emitted < cap || out == nullptr) {
    if (!eof) {
      size_t rd = std::fread(buf + have, 1, CH - have, f);
      if (rd < CH - have) eof = true;
      have += rd;
    }
    buf[have] = '\0';
    char* p = buf;
    char* end = buf + have;
    while (p < end && (to_skip > 0 || emitted < cap)) {
      char* next = nullptr;
      errno = 0;
      double v = std::strtod(p, &next);
      if (next == p) {
        ++p;  // non-numeric byte
        continue;
      }
      if (next == end && !eof) break;  // token may continue in next window
      if (to_skip > 0) {
        --to_skip;
      } else {
        if (out) out[emitted] = v;
        ++emitted;
      }
      last_end = base + (int64_t)(next - buf);
      p = next;
    }
    if (to_skip <= 0 && emitted >= cap && out != nullptr) break;
    size_t tail = static_cast<size_t>(end - p);
    if (tail == have && have == CH) {  // no progress: token wider than window
      std::free(buf);
      std::fclose(f);
      return -2;
    }
    base += (int64_t)(p - buf);
    std::memmove(buf, p, tail);
    have = tail;
    if (eof && tail == 0) break;
    if (eof && tail == have && p == buf) break;  // nothing parseable left
  }
  std::free(buf);
  std::fclose(f);
  if (end_byte) *end_byte = last_end;
  return emitted;
}

// ---------------------------------------------------------------------------
// Streaming block scan for the HPC-row format: one bounded-memory pass over
// the header + ALL per-row counts, returning [total_nrow, total_nnz,
// prefix_nnz_before_block, block_nnz, block_max_count, global_max_count]
// and the block's own counts. global_max_count spans every row, so all
// processes derive the same uniform ELL width without holding all counts.
// The caller then range-tokenizes exactly its (val, ind) pairs and
// x/b/xexact triples (read_HPC_row.cpp:255-293's per-rank read).
// Returns 0, -1 on IO error, -3 on a malformed/short header.
// ---------------------------------------------------------------------------
int32_t hpccg_scan_block(const char* path, int64_t start_row,
                         int64_t block_rows, int64_t* hdr_out,
                         int64_t* counts_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const size_t CH = 1 << 20;
  char* buf = static_cast<char*>(std::malloc(CH + 1));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  size_t have = 0;
  bool eof = false;
  int64_t tok = 0;  // token index in the file
  int64_t total_nrow = -1, total_nnz = -1;
  int64_t prefix = 0, block_nnz = 0, block_max = 0, global_max = 0;
  bool done = false;
  while (!done) {
    if (!eof) {
      size_t rd = std::fread(buf + have, 1, CH - have, f);
      if (rd < CH - have) eof = true;
      have += rd;
    }
    buf[have] = '\0';
    char* p = buf;
    char* end = buf + have;
    while (p < end) {
      char* next = nullptr;
      errno = 0;
      double v = std::strtod(p, &next);
      if (next == p) {
        ++p;
        continue;
      }
      if (next == end && !eof) break;
      if (tok == 0) {
        total_nrow = static_cast<int64_t>(v);
      } else if (tok == 1) {
        total_nnz = static_cast<int64_t>(v);
      } else {
        const int64_t row = tok - 2;
        if (row >= total_nrow) {
          done = true;  // scanned every count
          break;
        }
        const int64_t c = static_cast<int64_t>(v);
        if (c > global_max) global_max = c;
        if (row < start_row) {
          prefix += c;
        } else if (row < start_row + block_rows) {
          counts_out[row - start_row] = c;
          block_nnz += c;
          if (c > block_max) block_max = c;
        }
        if (row + 1 == total_nrow) {
          ++tok;
          done = true;
          break;
        }
      }
      ++tok;
      p = next;
    }
    if (done) break;
    size_t tail = static_cast<size_t>(end - p);
    if (tail == have && have == CH) {
      std::free(buf);
      std::fclose(f);
      return -2;
    }
    std::memmove(buf, p, tail);
    have = tail;
    if (eof && tail == 0) break;
  }
  std::free(buf);
  std::fclose(f);
  if (total_nrow < 0 || total_nnz < 0 || tok < 2 + total_nrow) {
    return -3;
  }
  hdr_out[0] = total_nrow;
  hdr_out[1] = total_nnz;
  hdr_out[2] = prefix;
  hdr_out[3] = block_nnz;
  hdr_out[4] = block_max;
  hdr_out[5] = global_max;
  return 0;
}

// ---------------------------------------------------------------------------
// ELL stencil assembly: the reference's generate_matrix triple loop
// (27-pt or 7-pt), emitting padded ELL directly. Row r of the local block
// owns global row start_row + r; columns are global; invalid slots get
// val=0, col=0, valid=0. width must be 27 (or 7 for seven_pt).
// Also writes b = A@ones into b_out. Returns total valid nnz.
// ---------------------------------------------------------------------------
int64_t hpccg_generate_ell(int32_t nx, int32_t ny, int32_t nz, int32_t rank,
                           int32_t size, int32_t seven_pt, double* vals,
                           int32_t* cols, uint8_t* valid, double* b_out) {
  const int64_t local_nrow = (int64_t)nx * ny * nz;
  const int64_t total_nrow = local_nrow * size;
  const int64_t start_row = local_nrow * rank;
  const int64_t plane = (int64_t)nx * ny;
  const int width = seven_pt ? 7 : 27;

  int64_t nnz = 0;
  for (int32_t iz = 0; iz < nz; ++iz) {
    for (int32_t iy = 0; iy < ny; ++iy) {
      for (int32_t ix = 0; ix < nx; ++ix) {
        const int64_t lrow = (int64_t)iz * plane + (int64_t)iy * nx + ix;
        const int64_t grow = start_row + lrow;
        double* vrow = vals + lrow * width;
        int32_t* crow = cols + lrow * width;
        uint8_t* mrow = valid + lrow * width;
        int slot = 0;
        int nnzrow = 0;
        for (int sz = -1; sz <= 1; ++sz) {
          for (int sy = -1; sy <= 1; ++sy) {
            for (int sx = -1; sx <= 1; ++sx) {
              if (seven_pt && sz * sz + sy * sy + sx * sx > 1) continue;
              const int64_t col = grow + (int64_t)sz * plane + (int64_t)sy * nx + sx;
              const bool ok = ix + sx >= 0 && ix + sx < nx && iy + sy >= 0 &&
                              iy + sy < ny && col >= 0 && col < total_nrow;
              if (ok) {
                vrow[slot] = (col == grow) ? 27.0 : -1.0;
                crow[slot] = (int32_t)col;
                mrow[slot] = 1;
                ++nnzrow;
              } else {
                vrow[slot] = 0.0;
                crow[slot] = 0;
                mrow[slot] = 0;
              }
              ++slot;
            }
          }
        }
        b_out[lrow] = 27.0 - (double)(nnzrow - 1);
        nnz += nnzrow;
      }
    }
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// HPC-row writer (inverse of read_HPC_row's format): header, per-row counts,
// (val, ind) pairs, then x/b/xexact triples. Returns 0 on success.
// ---------------------------------------------------------------------------
int32_t hpccg_write_hpc_row(const char* path, int64_t nrow, int32_t width,
                            const double* vals, const int32_t* cols,
                            const uint8_t* valid, const double* x,
                            const double* b, const double* xexact) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int64_t nnz = 0;
  for (int64_t i = 0; i < nrow * width; ++i) nnz += valid[i];
  std::fprintf(f, "%lld %lld\n", (long long)nrow, (long long)nnz);
  for (int64_t r = 0; r < nrow; ++r) {
    int cnt = 0;
    for (int32_t w = 0; w < width; ++w) cnt += valid[r * width + w];
    std::fprintf(f, "%d%c", cnt, r + 1 == nrow ? '\n' : ' ');
  }
  for (int64_t r = 0; r < nrow; ++r) {
    bool first = true;
    for (int32_t w = 0; w < width; ++w) {
      const int64_t k = r * width + w;
      if (!valid[k]) continue;
      std::fprintf(f, "%s%.17g %d", first ? "" : " ", vals[k], cols[k]);
      first = false;
    }
    std::fputc('\n', f);
  }
  for (int64_t r = 0; r < nrow; ++r) {
    std::fprintf(f, "%.17g %.17g %.17g\n", x[r], b[r], xexact[r]);
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering (the setup-phase index-relabeling tier —
// the role of make_local_matrix.cpp's renumbering pass, aimed at the DIA
// format and the ELL gather's locality). BFS from minimum-degree seeds with
// degree-sorted neighbor expansion; output reversed. Graph = symmetric
// union of the given (row, col) edges; duplicates are harmless (visited
// flags). Returns 0, or -1 on bad input.
int32_t hpccg_rcm(int64_t n, int64_t nnz, const int64_t* rows,
                  const int64_t* cols, int64_t* perm_out) {
  if (n < 0 || nnz < 0) return -1;
  std::vector<int64_t> deg(n, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t r = rows[i], c = cols[i];
    if (r < 0 || r >= n || c < 0 || c >= n) return -1;
    if (r != c) {
      deg[r]++;
      deg[c]++;
    }
  }
  std::vector<int64_t> indptr(n + 1, 0);
  for (int64_t v = 0; v < n; ++v) indptr[v + 1] = indptr[v] + deg[v];
  std::vector<int64_t> adj(indptr[n]);
  std::vector<int64_t> fill(indptr.begin(), indptr.end() - 1);
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t r = rows[i], c = cols[i];
    if (r != c) {
      adj[fill[r]++] = c;
      adj[fill[c]++] = r;
    }
  }
  std::vector<int64_t> seeds(n);
  for (int64_t v = 0; v < n; ++v) seeds[v] = v;
  std::stable_sort(seeds.begin(), seeds.end(),
                   [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
  std::vector<char> visited(n, 0);
  int64_t head = 0, tail = 0;
  std::vector<int64_t> nbrs;
  for (int64_t s : seeds) {
    if (visited[s]) continue;
    visited[s] = 1;
    perm_out[tail++] = s;
    while (head < tail) {
      const int64_t u = perm_out[head++];
      nbrs.clear();
      for (int64_t j = indptr[u]; j < indptr[u + 1]; ++j) {
        const int64_t v = adj[j];
        if (!visited[v]) {
          visited[v] = 1;  // mark now: dedups repeated edges in-place
          nbrs.push_back(v);
        }
      }
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
      });
      for (int64_t v : nbrs) perm_out[tail++] = v;
    }
  }
  std::reverse(perm_out, perm_out + n);
  return 0;
}

}  // extern "C"
