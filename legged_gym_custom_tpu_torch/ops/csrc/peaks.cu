// Measurement kernels of the roofline (ops/roofline.py): what this card
// sustains on the units and the memory the fused control step uses.
//
// They replace the on-chip microbenchmarks of the JAX package's
// legged_gym_custom_tpu/ops/roofline.py (measure_vpu_peak_gflops :155,
// measure_trans_rate_gops :176, measure_hbm_bw_gbps :196), which XLA ran as
// a lax.scan of jnp ops inside one dispatch.  An eager PyTorch chain cannot
// stand in on the card: each op is a launch and a round trip to device
// memory, so it would measure bandwidth, not the ALU.
//
//   lgc_fma_chain   each element stays in a register and takes iters x
//                   LGC_FMA_INNER dependent fmaf(c, a, b), four elements
//                   (four independent chains) a thread: bound by the fp32
//                   FMA pipes once the chains and the warps (blocks of 64,
//                   every SM full) hide the FMA latency;
//   lgc_tanh_chain  the same with c = tanhf(c) + b, LGC_TANH_INNER a
//                   step: tanhf is the transcendental the fused kernel
//                   calls (fused_step.cu, the frictionloss torque); bound by
//                   the special-function units that its exp and reciprocal
//                   use;
//   lgc_stream_add  out = x + 1 over an array far larger than the 50 MB L2,
//                   16 bytes a thread a load: bound by device memory.
//
// `a` and `b` are arguments, and the chains' results are written out, so
// that nvcc can neither fold nor drop the arithmetic.  Each entry point
// launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#define LGC_FMA_INNER 32
#define LGC_TANH_INNER 8
#define LGC_BLOCK 256
// the chains' blocks are small, so that the blocks of a 4 MB array spread
// over the 132 SMs to within a block of each other (32 resident a SM)
#define LGC_CHAIN_BLOCK 64

// Four elements a thread, each its own dependent chain: the four chains
// interleave, so a warp has an independent FMA (or tanhf) to issue while the
// one before waits on its result.
#define LGC_CHAIN4(STEP)    \
  c.x = STEP(c.x);          \
  c.y = STEP(c.y);          \
  c.z = STEP(c.z);          \
  c.w = STEP(c.w);

__global__ void fma_chain_kernel(float4* __restrict__ x, int n4, int iters, float a, float b) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 c = x[i];
#define LGC_FMA_STEP(v) fmaf(v, a, b)
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < LGC_FMA_INNER; ++k) { LGC_CHAIN4(LGC_FMA_STEP) }
  }
  x[i] = c;
}

__global__ void tanh_chain_kernel(float4* __restrict__ x, int n4, int iters, float b) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 c = x[i];
#define LGC_TANH_STEP(v) (tanhf(v) + b)
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < LGC_TANH_INNER; ++k) { LGC_CHAIN4(LGC_TANH_STEP) }
  }
  x[i] = c;
}

__global__ void stream_add_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                  long n4) {
  long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 v = x[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    out[i] = v;
  }
}

extern "C" {

int lgc_fma_inner() { return LGC_FMA_INNER; }
int lgc_tanh_inner() { return LGC_TANH_INNER; }

// n must be a multiple of 4 (four chains a thread); x 16-byte aligned
int lgc_fma_chain(float* x, int n, int iters, float a, float b, cudaStream_t stream) {
  int n4 = n / 4, grid = (n4 + LGC_CHAIN_BLOCK - 1) / LGC_CHAIN_BLOCK;
  fma_chain_kernel<<<grid, LGC_CHAIN_BLOCK, 0, stream>>>((float4*)x, n4, iters, a, b);
  return (int)cudaGetLastError();
}

int lgc_tanh_chain(float* x, int n, int iters, float b, cudaStream_t stream) {
  int n4 = n / 4, grid = (n4 + LGC_CHAIN_BLOCK - 1) / LGC_CHAIN_BLOCK;
  tanh_chain_kernel<<<grid, LGC_CHAIN_BLOCK, 0, stream>>>((float4*)x, n4, iters, b);
  return (int)cudaGetLastError();
}

// n must be a multiple of 4; x and out 16-byte aligned (torch allocations are)
int lgc_stream_add(const float* x, float* out, long n, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long n4 = n / 4;
  long want = (n4 + LGC_BLOCK - 1) / LGC_BLOCK;
  int grid = (int)(want < 8L * sms ? want : 8L * sms);
  stream_add_kernel<<<grid, LGC_BLOCK, 0, stream>>>((const float4*)x, (float4*)out, n4);
  return (int)cudaGetLastError();
}

const char* lgc_peaks_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
