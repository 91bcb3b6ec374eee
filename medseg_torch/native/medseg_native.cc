// medseg native host runtime: the data-path hot spots in C++.
//
// The reference's host pipeline leans on native code inside its dependencies
// (SURVEY.md §2.4): NiBabel's zlib decode for LoadImaged and torch's
// grid_sample for Spacingd resampling, running in 4 forked DataLoader workers
// (unetr_segmentation_3d.py:586-592). This library is the rebuild's
// first-party equivalent: OpenMP-parallel kernels invoked from the threaded
// Python loader through ctypes (no pybind11 in the image).
//
// Exposed C ABI:
//   msn_inflate_gzip    - gzip/zlib decode into a caller buffer
//   msn_trilinear_resample - affine trilinear resample (Spacingd "bilinear")
//   msn_nearest_resample   - affine nearest resample (Spacingd "nearest")
//   msn_scale_intensity    - windowed linear rescale (ScaleIntensityRanged)
//   msn_znorm_nonzero      - z-score over nonzero voxels (NormalizeIntensityd)
//   msn_foreground_bbox    - bounding box of voxels > threshold (CropForegroundd)
//
// Build: make (g++ -O3 -fopenmp -shared), see Makefile.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Decode a gzip (or raw zlib) stream into out; returns bytes written or -1.
long long msn_inflate_gzip(const unsigned char* in, long long in_len,
                           unsigned char* out, long long out_cap) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  // 15 + 32: auto-detect gzip/zlib headers
  if (inflateInit2(&zs, 15 + 32) != Z_OK) return -1;
  zs.next_in = const_cast<unsigned char*>(in);
  zs.avail_in = static_cast<uInt>(in_len);
  zs.next_out = out;
  zs.avail_out = static_cast<uInt>(out_cap);
  int ret = inflate(&zs, Z_FINISH);
  long long written = static_cast<long long>(zs.total_out);
  inflateEnd(&zs);
  if (ret != Z_STREAM_END) return -1;
  return written;
}

// Trilinear resample: dst[i,j,k] = src sampled at M @ (i,j,k,1) with border
// clamping (torch grid_sample padding_mode="border" contract used by MONAI
// Spacingd). src shape (sx, sy, sz, c) C-order float32; m is a row-major
// 3x4 matrix mapping dst voxel -> src voxel coordinates.
void msn_trilinear_resample(const float* src, long long sx, long long sy,
                            long long sz, long long c, const double* m,
                            float* dst, long long dx, long long dy,
                            long long dz) {
#pragma omp parallel for collapse(2) schedule(static)
  for (long long i = 0; i < dx; ++i) {
    for (long long j = 0; j < dy; ++j) {
      for (long long k = 0; k < dz; ++k) {
        double fx = m[0] * i + m[1] * j + m[2] * k + m[3];
        double fy = m[4] * i + m[5] * j + m[6] * k + m[7];
        double fz = m[8] * i + m[9] * j + m[10] * k + m[11];
        fx = std::min(std::max(fx, 0.0), double(sx - 1));
        fy = std::min(std::max(fy, 0.0), double(sy - 1));
        fz = std::min(std::max(fz, 0.0), double(sz - 1));
        long long x0 = (long long)fx, y0 = (long long)fy, z0 = (long long)fz;
        long long x1 = std::min(x0 + 1, sx - 1);
        long long y1 = std::min(y0 + 1, sy - 1);
        long long z1 = std::min(z0 + 1, sz - 1);
        double wx = fx - x0, wy = fy - y0, wz = fz - z0;
        const float* s = src;
        long long b000 = ((x0 * sy + y0) * sz + z0) * c;
        long long b001 = ((x0 * sy + y0) * sz + z1) * c;
        long long b010 = ((x0 * sy + y1) * sz + z0) * c;
        long long b011 = ((x0 * sy + y1) * sz + z1) * c;
        long long b100 = ((x1 * sy + y0) * sz + z0) * c;
        long long b101 = ((x1 * sy + y0) * sz + z1) * c;
        long long b110 = ((x1 * sy + y1) * sz + z0) * c;
        long long b111 = ((x1 * sy + y1) * sz + z1) * c;
        float* d = dst + ((i * dy + j) * dz + k) * c;
        for (long long ch = 0; ch < c; ++ch) {
          double c00 = s[b000 + ch] * (1 - wx) + s[b100 + ch] * wx;
          double c01 = s[b001 + ch] * (1 - wx) + s[b101 + ch] * wx;
          double c10 = s[b010 + ch] * (1 - wx) + s[b110 + ch] * wx;
          double c11 = s[b011 + ch] * (1 - wx) + s[b111 + ch] * wx;
          double c0 = c00 * (1 - wy) + c10 * wy;
          double c1 = c01 * (1 - wy) + c11 * wy;
          d[ch] = (float)(c0 * (1 - wz) + c1 * wz);
        }
      }
    }
  }
}

void msn_nearest_resample(const float* src, long long sx, long long sy,
                          long long sz, long long c, const double* m,
                          float* dst, long long dx, long long dy,
                          long long dz) {
#pragma omp parallel for collapse(2) schedule(static)
  for (long long i = 0; i < dx; ++i) {
    for (long long j = 0; j < dy; ++j) {
      for (long long k = 0; k < dz; ++k) {
        double fx = m[0] * i + m[1] * j + m[2] * k + m[3];
        double fy = m[4] * i + m[5] * j + m[6] * k + m[7];
        double fz = m[8] * i + m[9] * j + m[10] * k + m[11];
        // round half-to-even: torch grid_sample "nearest" uses nearbyint
        // (MONAI 0.6 Spacing's backend) and numpy round matches; llround
        // (half away from zero) would disagree on exact .5 coordinates
        long long x = (long long)std::nearbyint(fx);
        long long y = (long long)std::nearbyint(fy);
        long long z = (long long)std::nearbyint(fz);
        x = std::min(std::max(x, 0LL), sx - 1);
        y = std::min(std::max(y, 0LL), sy - 1);
        z = std::min(std::max(z, 0LL), sz - 1);
        const float* s = src + ((x * sy + y) * sz + z) * c;
        float* d = dst + ((i * dy + j) * dz + k) * c;
        for (long long ch = 0; ch < c; ++ch) d[ch] = s[ch];
      }
    }
  }
}

// ScaleIntensityRanged: linear [a_min,a_max] -> [b_min,b_max], clipped.
void msn_scale_intensity(float* data, long long n, float a_min, float a_max,
                         float b_min, float b_max, int clip) {
  const float scale = (b_max - b_min) / (a_max - a_min);
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < n; ++i) {
    float v = (data[i] - a_min) * scale + b_min;
    if (clip) v = std::min(std::max(v, b_min), b_max);
    data[i] = v;
  }
}

// NormalizeIntensityd(nonzero=True) for one channel plane (in place).
void msn_znorm_nonzero(float* data, long long n) {
  double sum = 0.0, sq = 0.0;
  long long cnt = 0;
#pragma omp parallel for reduction(+ : sum, sq, cnt) schedule(static)
  for (long long i = 0; i < n; ++i) {
    if (data[i] != 0.0f) {
      sum += data[i];
      sq += double(data[i]) * data[i];
      cnt += 1;
    }
  }
  if (cnt == 0) return;
  double mean = sum / cnt;
  double var = sq / cnt - mean * mean;
  double std = var > 0 ? std::sqrt(var) : 1.0;
  if (std == 0) std = 1.0;
  float fm = (float)mean, fs = (float)(1.0 / std);
#pragma omp parallel for schedule(static)
  for (long long i = 0; i < n; ++i) {
    if (data[i] != 0.0f) data[i] = (data[i] - fm) * fs;
  }
}

// Bounding box of data > threshold over an (x, y, z[, c]) volume.
// Writes [x0, x1, y0, y1, z0, z1) into bbox; returns 1 if any voxel found.
int msn_foreground_bbox(const float* data, long long sx, long long sy,
                        long long sz, long long c, float threshold,
                        long long* bbox) {
  long long x0 = sx, x1 = -1, y0 = sy, y1 = -1, z0 = sz, z1 = -1;
#pragma omp parallel
  {
    long long lx0 = sx, lx1 = -1, ly0 = sy, ly1 = -1, lz0 = sz, lz1 = -1;
#pragma omp for schedule(static) nowait
    for (long long x = 0; x < sx; ++x) {
      for (long long y = 0; y < sy; ++y) {
        const float* row = data + ((x * sy + y) * sz) * c;
        for (long long z = 0; z < sz; ++z) {
          const float* v = row + z * c;
          bool fg = false;
          for (long long ch = 0; ch < c; ++ch)
            if (v[ch] > threshold) { fg = true; break; }
          if (fg) {
            lx0 = std::min(lx0, x); lx1 = std::max(lx1, x);
            ly0 = std::min(ly0, y); ly1 = std::max(ly1, y);
            lz0 = std::min(lz0, z); lz1 = std::max(lz1, z);
          }
        }
      }
    }
#pragma omp critical
    {
      x0 = std::min(x0, lx0); x1 = std::max(x1, lx1);
      y0 = std::min(y0, ly0); y1 = std::max(y1, ly1);
      z0 = std::min(z0, lz0); z1 = std::max(z1, lz1);
    }
  }
  if (x1 < 0) return 0;
  bbox[0] = x0; bbox[1] = x1 + 1;
  bbox[2] = y0; bbox[3] = y1 + 1;
  bbox[4] = z0; bbox[5] = z1 + 1;
  return 1;
}

}  // extern "C"
