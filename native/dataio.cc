// Native IO helpers for porousfreezethaw.
//
// The reference implements its entire IO stack natively (libsource/dataIO,
// NetCDF block transcribe-and-send in intertrack.c:2459-2546, per-row CSV
// snapshot writes in spheres_*.c).  This framework keeps IO off the
// accelerator's critical path, but snapshot formatting is still host work
// that scales with grid/particle count; this module provides the hot
// encoders as a small C++ library bound via ctypes
// (porousfreezethaw/native.py), with pure-Python fallbacks.
//
// Build: native/build.sh  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Write n doubles as big-endian IEEE-754 at the current end of `path`
// (append) — the NetCDF classic variable-data encoder.
// Returns 0 on success.
int pft_append_f64_be(const char* path, const double* data, int64_t n) {
  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  const int64_t kChunk = 1 << 16;
  std::vector<uint64_t> buf(kChunk);
  int64_t done = 0;
  while (done < n) {
    int64_t m = n - done < kChunk ? n - done : kChunk;
    for (int64_t i = 0; i < m; i++) {
      uint64_t v;
      memcpy(&v, data + done + i, 8);
      v = __builtin_bswap64(v);
      buf[i] = v;
    }
    if (fwrite(buf.data(), 8, (size_t)m, f) != (size_t)m) {
      fclose(f);
      return -2;
    }
    done += m;
  }
  fclose(f);
  return 0;
}

// DEM CSV snapshot writer: column-major data (ncols arrays of nrows),
// printf "%f" formatting per value like spheres_*.c save_snapshot.
int pft_write_dem_csv(const char* path, const char* header,
                      const double* const* cols, int32_t ncols,
                      int64_t nrows) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  if (fputs(header, f) == EOF || fputc('\n', f) == EOF) {
    fclose(f);
    return -2;
  }
  for (int64_t r = 0; r < nrows; r++) {
    for (int32_t c = 0; c < ncols; c++) {
      if (c) fputc(',', f);
      fprintf(f, "%f", cols[c][r]);
    }
    fputc('\n', f);
  }
  fclose(f);
  return 0;
}

// Same but with a contiguous row-major (nrows, ncols) buffer.
int pft_write_dem_csv_rows(const char* path, const char* header,
                           const double* data, int32_t ncols, int64_t nrows) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  fputs(header, f);
  fputc('\n', f);
  for (int64_t r = 0; r < nrows; r++) {
    const double* row = data + r * ncols;
    for (int32_t c = 0; c < ncols; c++) {
      if (c) fputc(',', f);
      fprintf(f, "%f", row[c]);
    }
    fputc('\n', f);
  }
  fclose(f);
  return 0;
}

// VTK STRUCTURED_POINTS ASCII payload: values_per_line values per row with
// %.*g formatting (dataIO's VTK_export hot loop).
int pft_write_ascii_values(const char* path, const double* data, int64_t n,
                           int32_t values_per_line, int32_t precision) {
  FILE* f = fopen(path, "ab");
  if (!f) return -1;
  for (int64_t i = 0; i < n; i++) {
    fprintf(f, "%.*g", precision, data[i]);
    fputc((i + 1) % values_per_line == 0 || i + 1 == n ? '\n' : ' ', f);
  }
  fclose(f);
  return 0;
}

int pft_version(void) { return 1; }

}  // extern "C"
