// Greedy convolutional matching pursuit loop for NVIDIA Hopper (sm_90a),
// called from JAX through the XLA FFI (hsc_tpu/ops/greedy_cuda.py).
//
// One thread block encodes one signal block.  The per-position selection
// cache (colmax) lives in shared memory; the working score matrix [K, npos]
// lives in device memory and each accept reads and writes one K x (2W-1)
// window of it (the Gram tensor and the touched windows stay in L2).
//
// The arithmetic is the spec of `oracle.mp.mp_encode` and
// `ops.encode.mp_encode_from_init`: every float32 operation is one
// correctly rounded IEEE op (__fmul_rn / __fsub_rn / __fadd_rn, and the
// library is built with -fmad=false), so the emitted stream is bitwise the
// XLA loop's and the oracle's given the same initial scores.  Selection ties
// go to the lowest position, then the lowest atom.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Warp argmax with lowest-index tie-break; the result lands in lane 0.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(kFull, v, off);
    int oi = __shfl_down_sync(kFull, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

struct Broadcast {
  float v;
  int i;
  float s;
  int f;
};

// First position of the maximum of colmax[0, npos), returned to every thread.
__device__ int block_argmax(const float* colmax, int npos, float* red_v,
                            int* red_i, Broadcast* bc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float bv = -FLT_MAX;
  int bi = INT_MAX;
  for (int p = threadIdx.x; p < npos; p += kThreads) {
    float v = colmax[p];
    if (v > bv) {  // positions rise within a thread: the first maximum stays
      bv = v;
      bi = p;
    }
  }
  warp_argmax(bv, bi);
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = red_v[lane];
    bi = red_i[lane];
    warp_argmax(bv, bi);
    if (lane == 0) bc->i = bi;
  }
  __syncthreads();
  return bc->i;
}

// Best atom of score column t (|score| x weight, lowest atom on ties) and its
// raw score, returned to every thread through bc.
__device__ void column_select(const float* sc, int64_t npos, int k,
                              const float* wts, int t, Broadcast* bc) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float bv = -FLT_MAX;
    int bi = INT_MAX;
    for (int a = lane; a < k; a += 32) {
      float v = __fmul_rn(fabsf(sc[a * npos + t]), wts[a]);
      if (v > bv) {
        bv = v;
        bi = a;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      bc->f = bi;
      bc->s = sc[bi * npos + t];
    }
  }
  __syncthreads();
}

// scores[:, t-(W-1) : t+W] -= c_hat * gram_t[f], clipped to [0, npos), and
// the selection cache refreshed over the same positions.
__device__ void window_update(float* sc, int64_t npos, int k, int w,
                              const float* __restrict__ gram_t,
                              const float* wts, float* colmax, float* part,
                              int t, int f, float c_hat) {
  const int lag = 2 * w - 1;
  const int groups = lag >= kThreads ? 1 : kThreads / lag;
  const int base = t - (w - 1);
  const float* g = gram_t + (int64_t)f * k * lag;
  for (int idx = threadIdx.x; idx < groups * lag; idx += kThreads) {
    const int d = idx % lag;
    const int grp = idx / lag;
    const int p = base + d;
    float m = 0.0f;
    if (p >= 0 && p < npos) {
      for (int a = grp; a < k; a += groups) {
        float* ptr = sc + a * npos + p;
        const float prod = __fmul_rn(c_hat, __ldg(g + a * lag + d));
        const float v = __fsub_rn(*ptr, prod);
        *ptr = v;
        m = fmaxf(m, __fmul_rn(fabsf(v), wts[a]));
      }
    }
    part[idx] = m;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < lag; d += kThreads) {
    const int p = base + d;
    if (p >= 0 && p < npos) {
      float m = part[d];
      for (int grp = 1; grp < groups; ++grp) m = fmaxf(m, part[grp * lag + d]);
      colmax[p] = m;
    }
  }
  __syncthreads();
}

struct Quantized {
  int code;
  float c_hat_if_emitted;
};

// Spec quantizer: round half away from zero of s * inv_scale, clipped.
__device__ __forceinline__ Quantized quantize(float s, float inv_scale,
                                              float scale, float maxcode) {
  const float y = __fmul_rn(s, inv_scale);
  const float mag = floorf(__fadd_rn(fabsf(y), 0.5f));
  const float sgn = y > 0.0f ? 1.0f : (y < 0.0f ? -1.0f : 0.0f);
  const float r = fminf(fmaxf(mag * sgn, -maxcode), maxcode);
  Quantized q;
  q.code = static_cast<int>(r);
  q.c_hat_if_emitted = __fmul_rn(static_cast<float>(q.code), scale);
  return q;
}

__global__ void __launch_bounds__(kThreads, 1)
    greedy_mp_kernel(const float* __restrict__ scores0,
                     const float* __restrict__ e0s,
                     const float* __restrict__ scales,
                     const float* __restrict__ inv_scales,
                     const float* __restrict__ gram_t,
                     const float* __restrict__ weights, float* work,
                     int32_t* positions, int32_t* atoms, int32_t* codes,
                     int32_t* counts, float* e_res_out, int k, int64_t npos,
                     int w, int num_coefs, int num_select, int seg_len,
                     float maxcode, float snr_factor, int use_snr) {
  extern __shared__ float smem[];
  const int lag = 2 * w - 1;
  const int part_len = lag >= kThreads ? lag : kThreads;
  float* colmax = smem;
  float* part = colmax + npos;
  float* wts = part + part_len;
  float* cand_v = wts + k;
  int* cand_t = reinterpret_cast<int*>(cand_v + num_select);
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ Broadcast bc;

  const int64_t b = blockIdx.x;
  const float* s0 = scores0 + b * k * npos;
  float* sc = work + b * k * npos;
  int32_t* pos_out = positions + b * num_coefs;
  int32_t* atom_out = atoms + b * num_coefs;
  int32_t* code_out = codes + b * num_coefs;

  for (int a = threadIdx.x; a < k; a += kThreads) wts[a] = weights[a];
  for (int i = threadIdx.x; i < num_coefs; i += kThreads) {
    pos_out[i] = 0;
    atom_out[i] = 0;
    code_out[i] = 0;
  }
  __syncthreads();
  // working copy of the scores and the initial selection cache in one pass
  for (int64_t p = threadIdx.x; p < npos; p += kThreads) {
    float m = 0.0f;
    for (int a = 0; a < k; ++a) {
      const float v = s0[a * npos + p];
      sc[a * npos + p] = v;
      m = fmaxf(m, __fmul_rn(fabsf(v), wts[a]));
    }
    colmax[p] = m;
  }
  __syncthreads();

  const float scale = scales[b];
  const float inv_scale = inv_scales[b];
  const float e0 = e0s[b];
  const float snr_thr = use_snr ? __fmul_rn(e0, snr_factor) : -1.0f;
  float e_res = e0;
  int count = 0;
  bool done = !(scale > 0.0f);

  // one accepted event: record it, update the energy, the scores and the
  // selection cache; returns whether the SNR target is reached
  auto accept = [&](int t, int f, float s, int code, float c_hat) {
    if (threadIdx.x == 0) {
      pos_out[count] = t;
      atom_out[count] = f;
      code_out[count] = code;
    }
    ++count;
    const float e_step = __fmul_rn(__fmul_rn(2.0f, c_hat), s);
    const float e_sq = __fmul_rn(c_hat, c_hat);
    e_res = __fadd_rn(__fsub_rn(e_res, e_step), e_sq);
    window_update(sc, npos, k, w, gram_t, wts, colmax, part, t, f, c_hat);
    return e_res <= snr_thr;
  };

  if (num_select <= 1) {
    for (int it = 0; it < num_coefs && !done; ++it) {
      const int t = block_argmax(colmax, static_cast<int>(npos), red_v, red_i,
                                 &bc);
      column_select(sc, npos, k, wts, t, &bc);
      const int f = bc.f;
      const float s = bc.s;
      const Quantized q = quantize(s, inv_scale, scale, maxcode);
      if (q.code == 0) {
        done = true;
      } else if (accept(t, f, s, q.code, q.c_hat_if_emitted)) {
        done = true;
      }
    }
  } else {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    while (!done && count < num_coefs) {
      __syncthreads();  // every thread is done reading the last sweep's cands
      // one candidate per segment, all from the sweep-start cache
      for (int j = warp; j < num_select; j += kWarps) {
        const int lo = j * seg_len;
        const int hi = min(lo + seg_len, static_cast<int>(npos));
        float bv = -FLT_MAX;
        int bi = INT_MAX;
        for (int p = lo + lane; p < hi; p += 32) {
          const float v = colmax[p];
          if (v > bv) {
            bv = v;
            bi = p;
          }
        }
        warp_argmax(bv, bi);
        if (lane == 0) {
          cand_v[j] = bv;
          cand_t[j] = bi;
        }
      }
      __syncthreads();
      int last_t = -1;
      bool any_acc = false;
      for (int j = 0; j < num_select; ++j) {
        if (done || count >= num_coefs || !(cand_v[j] >= 0.0f)) continue;
        const int t = cand_t[j];
        column_select(sc, npos, k, wts, t, &bc);
        const int f = bc.f;
        const float s = bc.s;
        const Quantized q = quantize(s, inv_scale, scale, maxcode);
        const bool guard_ok = last_t < 0 || t - last_t >= lag;
        __syncthreads();  // bc is read before the next candidate rewrites it
        if (q.code == 0 || !guard_ok) continue;
        if (accept(t, f, s, q.code, q.c_hat_if_emitted)) done = true;
        last_t = t;
        any_acc = true;
      }
      if (!any_acc) done = true;
    }
  }
  if (threadIdx.x == 0) {
    counts[b] = count;
    e_res_out[b] = e_res > 0.0f ? e_res : 0.0f;
  }
}

}  // namespace

// Dynamic shared memory the kernel asks for; the Python wrapper mirrors it
// (ops.greedy_cuda.shared_memory_bytes) to route geometries that do not fit.
static int64_t SharedBytes(int64_t npos, int64_t k, int64_t w,
                           int64_t num_select) {
  const int64_t lag = 2 * w - 1;
  const int64_t part_len = lag >= kThreads ? lag : kThreads;
  return 4 * (npos + part_len + k + 2 * num_select);
}

static ffi::Error GreedyMpImpl(
    cudaStream_t stream, ffi::Buffer<ffi::F32> scores0,
    ffi::Buffer<ffi::F32> e0, ffi::Buffer<ffi::F32> scale,
    ffi::Buffer<ffi::F32> inv_scale, ffi::Buffer<ffi::F32> gram_t,
    ffi::Buffer<ffi::F32> weights, int32_t num_coefs, int32_t num_select,
    int32_t seg_len, float maxcode, float snr_factor, int32_t use_snr,
    int32_t max_shared, ffi::ResultBuffer<ffi::S32> positions,
    ffi::ResultBuffer<ffi::S32> atoms, ffi::ResultBuffer<ffi::S32> codes,
    ffi::ResultBuffer<ffi::S32> counts, ffi::ResultBuffer<ffi::F32> e_res,
    ffi::ResultBuffer<ffi::F32> work) {
  auto dims = scores0.dimensions();
  auto gdims = gram_t.dimensions();
  if (dims.size() != 3 || gdims.size() != 3) {
    return ffi::Error::InvalidArgument("scores0 and gram_t must be rank 3");
  }
  const int64_t nb = dims[0], k = dims[1], npos = dims[2];
  const int64_t lag = gdims[2];
  if (gdims[0] != k || gdims[1] != k || lag % 2 != 1) {
    return ffi::Error::InvalidArgument("gram_t must be [K, K, 2W-1]");
  }
  const int64_t w = (lag + 1) / 2;
  const int64_t smem = SharedBytes(npos, k, w, num_select);
  if (smem > max_shared) {
    return ffi::Error::InvalidArgument("geometry exceeds shared memory");
  }
  if (nb == 0) return ffi::Error::Success();
  cudaError_t err = cudaFuncSetAttribute(
      greedy_mp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  greedy_mp_kernel<<<static_cast<unsigned>(nb), kThreads,
                     static_cast<size_t>(smem), stream>>>(
      scores0.typed_data(), e0.typed_data(), scale.typed_data(),
      inv_scale.typed_data(), gram_t.typed_data(), weights.typed_data(),
      work->typed_data(), positions->typed_data(), atoms->typed_data(),
      codes->typed_data(), counts->typed_data(), e_res->typed_data(),
      static_cast<int>(k), npos, static_cast<int>(w), num_coefs, num_select,
      seg_len, maxcode, snr_factor, use_snr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(HscGreedyMp, GreedyMpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // scores0
                                  .Arg<ffi::Buffer<ffi::F32>>()  // e0
                                  .Arg<ffi::Buffer<ffi::F32>>()  // scale
                                  .Arg<ffi::Buffer<ffi::F32>>()  // inv_scale
                                  .Arg<ffi::Buffer<ffi::F32>>()  // gram_t
                                  .Arg<ffi::Buffer<ffi::F32>>()  // weights
                                  .Attr<int32_t>("num_coefs")
                                  .Attr<int32_t>("num_select")
                                  .Attr<int32_t>("seg_len")
                                  .Attr<float>("maxcode")
                                  .Attr<float>("snr_factor")
                                  .Attr<int32_t>("use_snr")
                                  .Attr<int32_t>("max_shared")
                                  .Ret<ffi::Buffer<ffi::S32>>()  // positions
                                  .Ret<ffi::Buffer<ffi::S32>>()  // atoms
                                  .Ret<ffi::Buffer<ffi::S32>>()  // codes
                                  .Ret<ffi::Buffer<ffi::S32>>()  // count
                                  .Ret<ffi::Buffer<ffi::F32>>()  // e_res
                                  .Ret<ffi::Buffer<ffi::F32>>()  // work
);
