// Native host-side IO runtime for x_multi_agent_jax.
//
// The reference is a C++ library fed by a ROS wrapper; here the host-side
// data path (dataset streaming: IMU CSV parsing, PGM image decoding,
// threaded batch prefetch) is native C++ behind a C ABI consumed via
// ctypes. The device compute path stays JAX/XLA.
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC).

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// IMU CSV: lines "t,wx,wy,wz,ax,ay,az" (EuRoC: ns timestamps). '#' comments.
// Returns number of rows parsed; fills out (cap rows max, 7 doubles/row).
// ---------------------------------------------------------------------------
long xio_load_imu_csv(const char* path, double* out, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(sz, '\0');
  if (fread(&buf[0], 1, sz, f) != (size_t)sz) {
    fclose(f);
    return -1;
  }
  fclose(f);

  long n = 0;
  const char* p = buf.c_str();
  const char* end = p + sz;
  while (p < end && n < cap) {
    while (p < end && (*p == '\n' || *p == '\r' || *p == ' ')) p++;
    if (p >= end) break;
    if (*p == '#') {  // comment line
      while (p < end && *p != '\n') p++;
      continue;
    }
    double row[7];
    int got = 0;
    for (; got < 7; ++got) {
      char* next = nullptr;
      row[got] = strtod(p, &next);
      if (next == p) break;
      p = next;
      if (p < end && *p == ',') p++;
    }
    if (got == 7) {
      memcpy(out + 7 * n, row, sizeof(row));
      n++;
    }
    while (p < end && *p != '\n') p++;
  }
  return n;
}

// ---------------------------------------------------------------------------
// PGM (P5, maxval <= 255): returns 0 on success; fills w/h and pixels
// (caller buffer of at least max_bytes).
// ---------------------------------------------------------------------------
static const unsigned char* skip_ws_comments(const unsigned char* p,
                                             const unsigned char* end) {
  for (;;) {
    while (p < end && isspace(*p)) p++;
    if (p < end && *p == '#') {
      while (p < end && *p != '\n') p++;
    } else {
      return p;
    }
  }
}

int xio_load_pgm(const char* path, unsigned char* pixels, long max_bytes,
                 int* out_w, int* out_h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<unsigned char> buf(sz);
  if (fread(buf.data(), 1, sz, f) != (size_t)sz) {
    fclose(f);
    return -2;
  }
  fclose(f);

  const unsigned char* p = buf.data();
  const unsigned char* end = p + sz;
  if (sz < 2 || p[0] != 'P' || p[1] != '5') return -3;
  p += 2;
  long vals[3];
  for (int i = 0; i < 3; ++i) {
    p = skip_ws_comments(p, end);
    long v = 0;
    bool any = false;
    while (p < end && isdigit(*p)) {
      v = v * 10 + (*p - '0');
      p++;
      any = true;
    }
    if (!any) return -4;
    vals[i] = v;
  }
  if (vals[2] > 255) return -5;  // 16-bit not supported here
  p++;                            // single whitespace after maxval
  long npix = vals[0] * vals[1];
  if (npix > max_bytes || p + npix > end) return -6;
  memcpy(pixels, p, npix);
  *out_w = (int)vals[0];
  *out_h = (int)vals[1];
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded batch PGM loader: paths are '\0'-separated; images must share
// (w, h). Fills out (n * w * h). Returns 0 on success, else first error.
// ---------------------------------------------------------------------------
int xio_load_pgm_batch(const char* paths, int n, unsigned char* out,
                       long stride, int* out_w, int* out_h, int n_threads) {
  std::vector<const char*> ps(n);
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    ps[i] = p;
    p += strlen(p) + 1;
  }
  std::atomic<int> next(0), err(0);
  std::vector<std::thread> threads;
  int nt = n_threads > 0 ? n_threads : 4;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n || err.load()) return;
        int w = 0, h = 0;
        int rc = xio_load_pgm(ps[i], out + stride * i, stride, &w, &h);
        if (rc != 0) {
          err.store(rc);
          return;
        }
        if (i == 0) {
          *out_w = w;
          *out_h = h;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  return err.load();
}

}  // extern "C"
