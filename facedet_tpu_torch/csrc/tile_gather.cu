// SAHI tile gather for Hopper (sm_90a): window copies of a device image into
// a tile batch.
//
// Replaces the two Pallas kernels of facedet_tpu/ops/pallas/tile_gather.py:
//   * tile_gather_hwc <- gather_tiles_pallas / _tile_gather_kernel (:40-74):
//     image [H,W,C] -> tiles [T,S_h,S_w,C];
//   * tile_gather_chw <- gather_tiles_pallas_static (:83-120):
//     image [C,H,W] -> tiles [T,C,S_h,S_w];
//   * tile_gather_chw_batched <- the same kernel under jax.vmap in the batch
//     pipeline (facedet_tpu/engine/predict.py:357-361): canvases [B,C,H,W]
//     and one offset list -> tiles [B*T,C,S_h,S_w], image-major, the flat
//     batch the detector's forward takes. One launch for the whole batch.
// The TPU kernels issue one DMA per tile, with the offsets scalar-prefetched
// (HWC) or baked in at compile time (CHW). Here a block reads its tile's
// (y, x) from the int32 offsets [T,2] in device memory, and each offset is
// mapped to a start index as lax.dynamic_slice maps it (dynamic_slice_start).
//
// Bound: bytes; the gather does no arithmetic. Each output row is one
// contiguous run of a source row, and the kernel reads every tile byte once
// and writes it once: 2*T*S_h*S_w*C*elem bytes. At the production grid
// (canvas 1024x1536x3, T=6, S=640) that is 59 MB in float32, 17.6 us at
// 3.35 TB/s, and 8.8 us in bfloat16. The tiles overlap, so the least traffic
// is less: the union of the windows (here the whole canvas) read once plus
// the tiles written once, 48.4 MB in float32 (14.4 us) and 24.2 MB in
// bfloat16 (7.2 us); overlapping reads can hit the 50 MB L2.
// Design, HWC: one block per tile row (S_w*C elements, 3.8 kB in bfloat16 at
// the production grid); its threads stride along the row with 16-byte loads
// and stores when source and destination agree modulo 16 (true at the
// production grid for every dtype), else with 4-byte words, else bytes.
// Design, CHW: a row of one channel plane is a third of that (640 bfloat16
// values are 80 16-byte vectors), too little for a block. So a block copies
// a band of rows of one (tile, channel) plane, about kBandBytes of traffic:
// it reads the tile's offsets once, picks once the widest vector (16, 8, 4,
// 2 or 1 bytes) that divides the row length, both row strides and both
// band starts, flattens (row, vector) into one index so that every thread
// is busy, and starts up to kUnroll independent loads per thread before
// their stores, which keeps enough bytes in flight on each SM to cover the
// latency of device memory. Where only the window's start is unaligned (an
// odd x offset: the enhance-first pipeline's 4x4 grid has them) the stores
// stay aligned 16-byte vectors, each assembled from two aligned loads. At the
// production grid (3x1024x1536 bfloat16, T=6, S=640) that is 1,440 blocks of
// 8 rows and 10 kB, five 16-byte loads a thread, against 11,520 one-row
// blocks before. grid.z carries the image
// of a batch, whose traffic and bound are B times one image's (B=16
// bfloat16 canvases at the production grid: 387 MB, 115 us). The copy is
// element-type agnostic: uint8, float32 and bfloat16 all move as bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;  // HWC: threads of a one-row block

// CHW: threads of a band block, independent loads a thread starts before its
// stores, and the traffic a band is sized to. The macros let a tuning build
// try other values (tools/gather_bench.py).
#ifndef FACEDET_BAND_THREADS
#define FACEDET_BAND_THREADS 128
#endif
#ifndef FACEDET_BAND_UNROLL
#define FACEDET_BAND_UNROLL 8
#endif
#ifndef FACEDET_BAND_BYTES
#define FACEDET_BAND_BYTES 10240
#endif
constexpr int kBandThreads = FACEDET_BAND_THREADS;
constexpr int kUnroll = FACEDET_BAND_UNROLL;
constexpr long long kBandBytes = FACEDET_BAND_BYTES;

template <typename V>
__device__ __forceinline__ void copy_run(const unsigned char* __restrict__ src,
                                         unsigned char* __restrict__ dst,
                                         long long n) {
  constexpr long long kW = sizeof(V);
  long long head = (kW - static_cast<long long>(reinterpret_cast<uintptr_t>(src) % kW)) % kW;
  if (head > n) head = n;
  const long long body = (n - head) / kW;
  for (long long i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const V* __restrict__ sv = reinterpret_cast<const V*>(src + head);
  V* __restrict__ dv = reinterpret_cast<V*>(dst + head);
  for (long long i = threadIdx.x; i < body; i += blockDim.x) dv[i] = sv[i];
  for (long long i = head + body * kW + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void copy_row(const unsigned char* src, unsigned char* dst,
                                         long long n) {
  const uintptr_t skew = reinterpret_cast<uintptr_t>(src) ^ reinterpret_cast<uintptr_t>(dst);
  if ((skew & 15) == 0) {
    copy_run<uint4>(src, dst, n);
  } else if ((skew & 3) == 0) {
    copy_run<uint32_t>(src, dst, n);
  } else {
    copy_run<unsigned char>(src, dst, n);
  }
}

// lax.dynamic_slice's start index: a negative offset counts from the end of
// the axis, then the window is clamped into [0, dim - size].
__device__ __forceinline__ int dynamic_slice_start(int off, int dim, int size) {
  if (off < 0) off += dim;
  return min(max(off, 0), dim - size);
}

// HWC: grid = (S_h, T), one block per tile row.
__global__ void __launch_bounds__(kThreads)
tile_gather_hwc_kernel(const unsigned char* __restrict__ img, const int* __restrict__ offs,
                       unsigned char* __restrict__ out, int H, int W, int C, int Sh, int Sw,
                       int elem) {
  const int r = blockIdx.x;
  const int t = blockIdx.y;
  const int oy = dynamic_slice_start(offs[2 * t], H, Sh);
  const int ox = dynamic_slice_start(offs[2 * t + 1], W, Sw);
  const long long src = (static_cast<long long>(oy + r) * W + ox) * C;
  const long long dst = (static_cast<long long>(t) * Sh + r) * Sw * C;
  copy_row(img + src * elem, out + dst * elem, static_cast<long long>(Sw) * C * elem);
}

// Copies `rows` rows of `n` bytes (rows `src_stride` / `dst_stride` bytes
// apart) as vectors of type V. Every row start and n are multiples of
// sizeof(V). A thread loads up to kUnroll vectors, then stores them.
template <typename V>
__device__ __forceinline__ void copy_band(const unsigned char* __restrict__ src,
                                          unsigned char* __restrict__ dst,
                                          long long src_stride, long long dst_stride,
                                          unsigned rows, unsigned n) {
  const unsigned per_row = n / sizeof(V);
  const unsigned total = rows * per_row;
  for (unsigned base = threadIdx.x; base < total; base += kUnroll * kBandThreads) {
    V v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned i = base + k * kBandThreads;
      if (i < total) {
        const unsigned row = i / per_row;
        const unsigned col = i - row * per_row;
        v[k] = *reinterpret_cast<const V*>(src + row * src_stride + col * sizeof(V));
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const unsigned i = base + k * kBandThreads;
      if (i < total) {
        const unsigned row = i / per_row;
        const unsigned col = i - row * per_row;
        *reinterpret_cast<V*>(dst + row * dst_stride + col * sizeof(V)) = v[k];
      }
    }
  }
}

// Bytes shift .. shift+15 of the 32 bytes (lo, hi), 0 <= shift < 16.
__device__ __forceinline__ uint4 shift_pair(const uint4 lo, const uint4 hi, unsigned shift) {
  const unsigned bits = (shift & 3) * 8;
  unsigned w0, w1, w2, w3, w4;
  switch (shift >> 2) {
    case 0: w0 = lo.x; w1 = lo.y; w2 = lo.z; w3 = lo.w; w4 = hi.x; break;
    case 1: w0 = lo.y; w1 = lo.z; w2 = lo.w; w3 = hi.x; w4 = hi.y; break;
    case 2: w0 = lo.z; w1 = lo.w; w2 = hi.x; w3 = hi.y; w4 = hi.z; break;
    default: w0 = lo.w; w1 = hi.x; w2 = hi.y; w3 = hi.z; w4 = hi.w; break;
  }
  return make_uint4(__funnelshift_r(w0, w1, bits), __funnelshift_r(w1, w2, bits),
                    __funnelshift_r(w2, w3, bits), __funnelshift_r(w3, w4, bits));
}

// The band copy for a destination whose rows are 16-byte aligned and a
// source that starts anywhere (a window at an odd x): every store is one
// aligned 16-byte vector, assembled from the two aligned 16-byte vectors of
// the source that hold its bytes. Both lie in aligned 16-byte chunks that
// hold at least one byte of the row, so no load leaves the row's pages.
__device__ __forceinline__ void copy_band_shifted(const unsigned char* __restrict__ src,
                                                  unsigned char* __restrict__ dst,
                                                  long long src_stride, long long dst_stride,
                                                  unsigned rows, unsigned n) {
  constexpr int kPairs = kUnroll > 1 ? kUnroll / 2 : 1;  // two loads per store
  const unsigned per_row = n / 16;
  const unsigned total = rows * per_row;
  for (unsigned base = threadIdx.x; base < total; base += kPairs * kBandThreads) {
    uint4 lo[kPairs], hi[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const unsigned i = base + k * kBandThreads;
      if (i < total) {
        const unsigned row = i / per_row;
        const unsigned col = i - row * per_row;
        const unsigned char* s = src + row * src_stride + col * 16;
        const unsigned shift = reinterpret_cast<uintptr_t>(s) & 15;
        lo[k] = *reinterpret_cast<const uint4*>(s - shift);
        hi[k] = shift ? *reinterpret_cast<const uint4*>(s - shift + 16) : lo[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const unsigned i = base + k * kBandThreads;
      if (i < total) {
        const unsigned row = i / per_row;
        const unsigned col = i - row * per_row;
        const unsigned shift =
            reinterpret_cast<uintptr_t>(src + row * src_stride + col * 16) & 15;
        *reinterpret_cast<uint4*>(dst + row * dst_stride + col * 16) =
            shift_pair(lo[k], hi[k], shift);
      }
    }
  }
}

// CHW: grid = (bands, T*C, B). A block copies `band` rows (fewer in the last
// band) of one channel plane of one tile; B images of one size share the
// offsets (B = 1 for the single-image entry).
__global__ void __launch_bounds__(kBandThreads)
tile_gather_chw_kernel(const unsigned char* __restrict__ img, const int* __restrict__ offs,
                       unsigned char* __restrict__ out, int H, int W, int C, int Sh, int Sw,
                       int elem, int band) {
  const int r0 = blockIdx.x * band;
  const int plane = blockIdx.y;
  const int b = blockIdx.z;
  const int t = plane / C;
  const int c = plane - t * C;
  const int oy = dynamic_slice_start(offs[2 * t], H, Sh);
  const int ox = dynamic_slice_start(offs[2 * t + 1], W, Sw);
  const unsigned rows = min(band, Sh - r0);
  const unsigned n = static_cast<unsigned>(Sw) * elem;
  const long long src_stride = static_cast<long long>(W) * elem;
  const long long dst_stride = n;
  const unsigned char* src =
      img + (((static_cast<long long>(b) * C + c) * H + oy + r0) * W + ox) * elem;
  unsigned char* dst =
      out + ((static_cast<long long>(b) * gridDim.y + plane) * Sh + r0) * dst_stride;
  // one decision for the band: every row start is src + k*src_stride and
  // dst + k*dst_stride, so what divides all five divides every address
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                          static_cast<uintptr_t>(src_stride) | static_cast<uintptr_t>(dst_stride);
  if ((align & 15) == 0) {
    copy_band<uint4>(src, dst, src_stride, dst_stride, rows, n);
  } else if (((reinterpret_cast<uintptr_t>(dst) | static_cast<uintptr_t>(dst_stride)) & 15) == 0) {
    // the rows of the tile are aligned (S_w*elem is a multiple of 16) and
    // only the window's start is not
    copy_band_shifted(src, dst, src_stride, dst_stride, rows, n);
  } else if ((align & 7) == 0) {
    copy_band<uint2>(src, dst, src_stride, dst_stride, rows, n);
  } else if ((align & 3) == 0) {
    copy_band<uint32_t>(src, dst, src_stride, dst_stride, rows, n);
  } else if ((align & 1) == 0) {
    copy_band<uint16_t>(src, dst, src_stride, dst_stride, rows, n);
  } else {
    copy_band<unsigned char>(src, dst, src_stride, dst_stride, rows, n);
  }
}

int launch_hwc(const void* img, const void* offs, void* out, int T, int H, int W, int C, int Sh,
               int Sw, int elem, void* stream) {
  if (T <= 0 || Sh <= 0 || Sw <= 0 || C <= 0) return 0;
  tile_gather_hwc_kernel<<<dim3(Sh, T), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(img), static_cast<const int*>(offs),
      static_cast<unsigned char*>(out), H, W, C, Sh, Sw, elem);
  return static_cast<int>(cudaGetLastError());
}

int launch_chw(const void* img, const void* offs, void* out, int B, int T, int H, int W, int C,
               int Sh, int Sw, int elem, void* stream) {
  if (B <= 0 || T <= 0 || Sh <= 0 || Sw <= 0 || C <= 0) return 0;
  const long long row_bytes = static_cast<long long>(Sw) * elem;
  const int band = static_cast<int>(std::min<long long>(Sh, std::max<long long>(1, kBandBytes / row_bytes)));
  const dim3 grid((Sh + band - 1) / band, T * C, B);
  tile_gather_chw_kernel<<<grid, kBandThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(img), static_cast<const int*>(offs),
      static_cast<unsigned char*>(out), H, W, C, Sh, Sw, elem, band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All return the cudaError_t of the launch (0 on success). The caller checks
// shapes, bounds (S_h <= H, S_w <= W) and that T*C fits grid.y and B grid.z.
extern "C" int facedet_tile_gather_hwc(const void* img, const void* offs, void* out, int T,
                                       int H, int W, int C, int Sh, int Sw, int elem,
                                       void* stream) {
  return launch_hwc(img, offs, out, T, H, W, C, Sh, Sw, elem, stream);
}

extern "C" int facedet_tile_gather_chw(const void* img, const void* offs, void* out, int T,
                                       int C, int H, int W, int Sh, int Sw, int elem,
                                       void* stream) {
  return launch_chw(img, offs, out, 1, T, H, W, C, Sh, Sw, elem, stream);
}

extern "C" int facedet_tile_gather_chw_batched(const void* img, const void* offs, void* out,
                                               int B, int T, int C, int H, int W, int Sh,
                                               int Sw, int elem, void* stream) {
  return launch_chw(img, offs, out, B, T, H, W, C, Sh, Sw, elem, stream);
}
