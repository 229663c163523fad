// Native IO runtime for cbet_raytracing_3d_tpu.
//
// Native equivalents of the reference's C++ host runtime pieces:
//   - radial profile text parsing      (main.cu:246-260)
//   - the -D PRINT nested dump writer  (main.cu:6-22,353-355)
//   - the 27-node edep box average     (main.cu:334-349)
//
// Exposed as a plain C ABI consumed via ctypes (utils/native.py), with a
// NumPy fallback when the shared library is absent.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Parse up to `max_rows` whitespace-separated (r, value) pairs from a text
// file. Returns rows read, or -1 on open failure.
int cbet_parse_profile(const char* path, int max_rows, double* r_out,
                       double* v_out) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  int n = 0;
  while (n < max_rows && std::fscanf(f, "%lf %lf", &r_out[n], &v_out[n]) == 2) {
    ++n;
  }
  std::fclose(f);
  return n;
}

// Write the reference -D PRINT dump of a 3-D double array: nested
// [a,b,...] lists, ']' + '\n' at every level, entries formatted with %g
// (C++ ostream default 6 significant digits). Returns 0 on success.
int cbet_write_print_dump(const char* path, const double* data, int n0,
                          int n1, int n2) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::string buf;
  buf.reserve((size_t)n0 * n1 * n2 * 14);
  char num[64];
  buf += '[';
  for (int i = 0; i < n0; ++i) {
    buf += '[';
    for (int j = 0; j < n1; ++j) {
      buf += '[';
      const double* row = data + ((size_t)i * n1 + j) * n2;
      for (int k = 0; k < n2; ++k) {
        int len = std::snprintf(num, sizeof num, "%g", row[k]);
        buf.append(num, len);
        if (k != n2 - 1) buf += ',';
      }
      buf += "]\n";
      if (j != n1 - 1) buf += ',';
    }
    buf += "]\n";
    if (i != n0 - 1) buf += ',';
  }
  buf += "]\n";
  size_t wrote = std::fwrite(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return wrote == buf.size() ? 0 : -2;
}

// 27-node box average (main.cu:334-349): out[i,j,k] = mean of the 3x3x3
// ghost-padded stencil. `in` is (n0+2, n1+2, n2+2); `out` is (n0, n1, n2).
void cbet_box_average27(const double* in, double* out, int n0, int n1,
                        int n2) {
  const int p1 = n1 + 2, p2 = n2 + 2;
  for (int i = 0; i < n0; ++i) {
    for (int j = 0; j < n1; ++j) {
      for (int k = 0; k < n2; ++k) {
        double s = 0.0;
        for (int a = 0; a < 3; ++a)
          for (int b = 0; b < 3; ++b) {
            const double* row = in + ((size_t)(i + a) * p1 + (j + b)) * p2 + k;
            s += row[0] + row[1] + row[2];
          }
        out[((size_t)i * n1 + j) * n2 + k] = s / 27.0;
      }
    }
  }
}

}  // extern "C"
