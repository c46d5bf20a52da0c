// SAHI tile gather for Hopper (sm_90a): window copies of a device image into
// a tile batch.
//
// Replaces the two Pallas kernels of facedet_tpu/ops/pallas/tile_gather.py:
//   * tile_gather_hwc <- gather_tiles_pallas / _tile_gather_kernel (:40-74):
//     image [H,W,C] -> tiles [T,S_h,S_w,C];
//   * tile_gather_chw <- gather_tiles_pallas_static (:83-120):
//     image [C,H,W] -> tiles [T,C,S_h,S_w].
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
// Design: one block per (tile row) in HWC and per (tile, channel, row) in
// CHW; the threads of a block stride along the row with 16-byte loads and
// stores when source and destination agree modulo 16 (true at the production
// grid for every dtype), else with 4-byte words, else bytes. The copy is
// element-type agnostic: uint8, float32 and bfloat16 all move as bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

// grid = (S_h, planes): planes = T for HWC, T*C for CHW.
template <bool kChw>
__global__ void __launch_bounds__(kThreads)
tile_gather_kernel(const unsigned char* __restrict__ img, const int* __restrict__ offs,
                   unsigned char* __restrict__ out, int H, int W, int C, int Sh, int Sw,
                   int elem) {
  const int r = blockIdx.x;
  const int plane = blockIdx.y;
  const int t = kChw ? plane / C : plane;
  const int oy = dynamic_slice_start(offs[2 * t], H, Sh);
  const int ox = dynamic_slice_start(offs[2 * t + 1], W, Sw);
  long long src, dst, n;
  if (kChw) {
    const int c = plane - t * C;
    src = (static_cast<long long>(c) * H + oy + r) * W + ox;
    dst = (static_cast<long long>(plane) * Sh + r) * Sw;
    n = Sw;
  } else {
    src = (static_cast<long long>(oy + r) * W + ox) * C;
    dst = (static_cast<long long>(t) * Sh + r) * Sw * C;
    n = static_cast<long long>(Sw) * C;
  }
  copy_row(img + src * elem, out + dst * elem, n * elem);
}

template <bool kChw>
int launch(const void* img, const void* offs, void* out, int T, int H, int W, int C, int Sh,
           int Sw, int elem, void* stream) {
  if (T <= 0 || Sh <= 0 || Sw <= 0 || C <= 0) return 0;
  const dim3 grid(Sh, kChw ? T * C : T);
  tile_gather_kernel<kChw><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(img), static_cast<const int*>(offs),
      static_cast<unsigned char*>(out), H, W, C, Sh, Sw, elem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success). The caller
// checks shapes, bounds (S_h <= H, S_w <= W) and that T*C fits grid.y.
extern "C" int facedet_tile_gather_hwc(const void* img, const void* offs, void* out, int T,
                                       int H, int W, int C, int Sh, int Sw, int elem,
                                       void* stream) {
  return launch<false>(img, offs, out, T, H, W, C, Sh, Sw, elem, stream);
}

extern "C" int facedet_tile_gather_chw(const void* img, const void* offs, void* out, int T,
                                       int C, int H, int W, int Sh, int Sw, int elem,
                                       void* stream) {
  return launch<true>(img, offs, out, T, H, W, C, Sh, Sw, elem, stream);
}
