// group_norm: GroupNorm over an NHWC bf16 activation with fp32 statistics,
// optionally preceded by per-channel input bias terms and followed by SiLU:
//
//   v = x + b1 + b2                      (fp32; each term [C] or [B, C], bf16)
//   mean, m2 = E[v], E[v^2] over each (batch row, group)
//   inv = rsqrt(max(m2 - mean^2, 0) + eps)
//   y = v * a + shift, a = inv * gamma, shift = beta - mean * a   (fp32)
//   y = y * sigmoid(y) where act, stored as bf16 rounded once
//
// Replaces no TPU kernel: the JAX package's GroupNorm is plain jnp, which XLA
// fuses into two reductions and one elementwise pass; PyTorch runs the same
// function as four passes over the activation and a dozen [B, G] kernels
// (ops/primitives.py::group_norm_plain). The bias terms take the resnets'
// conv1 bias (and the UNet's time-embedding projection) into the norm that
// is the conv output's one consumer, instead of a read-modify-write pass of
// their own.
//
// What bounds it on the H100: bytes. One read of x for the statistics, one
// read of x and one write of y for the output, 3 x 2 bytes an element, at
// 3.35 TB/s; the arithmetic is a few operations an element.
//
// Design: two launches, grid (blocks a row, B). A thread owns 8 consecutive
// channels (one 16-byte vector) for the whole launch, and the block's
// threads walk the block's pixel range as one linear sweep of 16-byte
// vectors (neighbouring threads on neighbouring addresses), four vectors in
// flight a thread. Every group size (4 to 80 channels, and widths that
// are no multiple of 8 channels a group) is one code path: the statistics
// are per channel in registers, folded to groups once at the block's end
// through shared memory. The stats kernel writes a (sum, sum of squares)
// partial per (row, block, group) to a workspace; each apply block reduces
// its row's partials in a fixed order first. No float atomics: the result
// repeats bit for bit. The blocks a row fill one wave of the card (the
// occupancy of both kernels), so that the partials stay few and every block
// runs at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;    // threads a block: R rows of V = C / 8 vectors; two fit an SM
constexpr int kMaxChannels = 4096;  // C <= 8 * kMaxThreads
constexpr int kMaxGroups = 256;     // <= the fewest threads a block has (257)

struct Terms {
  const __nv_bfloat16* b1;  // or null
  const __nv_bfloat16* b2;  // or null
  int s1, s2;               // row strides: 0 for [C], C for [B, C]
};

__device__ __forceinline__ void load_bias(const Terms& t, int b, int c0, float (&bias)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) bias[i] = 0.f;
  if (t.b1 != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) bias[i] += __bfloat162float(t.b1[(int64_t)b * t.s1 + c0 + i]);
  }
  if (t.b2 != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) bias[i] += __bfloat162float(t.b2[(int64_t)b * t.s2 + c0 + i]);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void accumulate(const uint4& u, const float (&bias)[8], float (&s)[8],
                                           float (&q)[8]) {
  float f[8];
  unpack(u, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = f[i] + bias[i];
    s[i] += v;
    q[i] = fmaf(v, v, q[i]);
  }
}

__device__ __forceinline__ uint4 normalise(const uint4& u, const float (&a)[8],
                                           const float (&shift)[8], bool act) {
  float f[8];
  unpack(u, f);
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float y0 = fmaf(f[2 * i], a[2 * i], shift[2 * i]);
    float y1 = fmaf(f[2 * i + 1], a[2 * i + 1], shift[2 * i + 1]);
    if (act) {
      y0 = y0 / (1.f + __expf(-y0));
      y1 = y1 / (1.f + __expf(-y1));
    }
    h[i] = __floats2bfloat162_rn(y0, y1);
  }
  return out;
}

// Per (row b, block j): the (sum, sum of squares) of x + bias over the
// block's pixels [j * P, min((j + 1) * P, HW)), per group, into
// ws[(b * nblk + j) * G + g].
__global__ void __launch_bounds__(kMaxThreads, 2)
irt_group_norm_stats_kernel(const __nv_bfloat16* __restrict__ x, Terms terms,
                            float2* __restrict__ ws, int HW, int C, int G, int R, int P) {
  __shared__ float sh_s[8 * kMaxThreads];
  __shared__ float sh_q[8 * kMaxThreads];
  const int V = C >> 3, T = R * V;
  const int t = threadIdx.x, r = t / V, v = t - r * V;
  const int b = blockIdx.y, j = blockIdx.x, nblk = gridDim.x;
  const int p1 = min(HW, (j + 1) * P);

  float bias[8], s[8], q[8];
  load_bias(terms, b, 8 * v, bias);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.f;

  const uint4* xv = reinterpret_cast<const uint4*>(x) + (int64_t)b * HW * V + v;
  int p = j * P + r;
  for (; p + 3 * R < p1; p += 4 * R) {
    const uint4 u0 = xv[(int64_t)p * V];
    const uint4 u1 = xv[(int64_t)(p + R) * V];
    const uint4 u2 = xv[(int64_t)(p + 2 * R) * V];
    const uint4 u3 = xv[(int64_t)(p + 3 * R) * V];
    accumulate(u0, bias, s, q);
    accumulate(u1, bias, s, q);
    accumulate(u2, bias, s, q);
    accumulate(u3, bias, s, q);
  }
  for (; p < p1; p += R) accumulate(xv[(int64_t)p * V], bias, s, q);

  // per channel: thread t's 8 channels sit at row r, columns 8v..8v+7 of an
  // [R, C] table; fold the rows, then the channels of each group
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sh_s[8 * t + i] = s[i];
    sh_q[8 * t + i] = q[i];
  }
  __syncthreads();
  for (int c = t; c < C; c += T) {
    float cs = 0.f, cq = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      cs += sh_s[rr * C + c];
      cq += sh_q[rr * C + c];
    }
    sh_s[c] = cs;  // column c is this thread's alone
    sh_q[c] = cq;
  }
  __syncthreads();
  const int cg = C / G, warp = t >> 5, lane = t & 31, warps = T >> 5;  // whole warps only
  for (int g = warp; warp < warps && g < G; g += warps) {
    float gs = 0.f, gq = 0.f;
    for (int c = lane; c < cg; c += 32) {
      gs += sh_s[g * cg + c];
      gq += sh_q[g * cg + c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      gs += __shfl_xor_sync(0xffffffffu, gs, o);
      gq += __shfl_xor_sync(0xffffffffu, gq, o);
    }
    if (lane == 0) ws[((int64_t)b * nblk + j) * G + g] = make_float2(gs, gq);
  }
}

// Per (row b, block j): the row's statistics from its nblk partials, then
// y = act((x + bias) * a + shift) over the block's pixels.
__global__ void __launch_bounds__(kMaxThreads, 2)
irt_group_norm_apply_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ gamma,
                            const void* __restrict__ beta, int affine_f32, Terms terms,
                            const float2* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                            int HW, int C, int G, int R, int P, int act, float eps) {
  __shared__ float2 sh_part[kMaxThreads];
  __shared__ float sh_mean[kMaxGroups];
  __shared__ float sh_inv[kMaxGroups];
  const int V = C >> 3, T = R * V;
  const int t = threadIdx.x, r = t / V, v = t - r * V;
  const int b = blockIdx.y, j = blockIdx.x, nblk = gridDim.x;
  const int cg = C / G;

  // the row's partials: L lanes a group, each over every L-th block, then
  // the lanes in order
  const int L = T / G;
  if (t < L * G) {
    const int g = t % G, l = t / G;
    float gs = 0.f, gq = 0.f;
    for (int jj = l; jj < nblk; jj += L) {
      const float2 w = ws[((int64_t)b * nblk + jj) * G + g];
      gs += w.x;
      gq += w.y;
    }
    sh_part[t] = make_float2(gs, gq);
  }
  __syncthreads();
  if (t < G) {
    float gs = 0.f, gq = 0.f;
    for (int l = 0; l < L; ++l) {
      gs += sh_part[l * G + t].x;
      gq += sh_part[l * G + t].y;
    }
    const float n = (float)HW * (float)cg;
    const float mean = gs / n, m2 = gq / n;
    sh_mean[t] = mean;
    sh_inv[t] = rsqrtf(fmaxf(m2 - mean * mean, 0.f) + eps);
  }
  __syncthreads();

  // this thread's channels: y = x * a + (shift + bias * a)
  float bias[8], a[8], shift[8];
  load_bias(terms, b, 8 * v, bias);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * v + i, g = c / cg;
    const float w = affine_f32 ? static_cast<const float*>(gamma)[c]
                               : __bfloat162float(static_cast<const __nv_bfloat16*>(gamma)[c]);
    const float o = affine_f32 ? static_cast<const float*>(beta)[c]
                               : __bfloat162float(static_cast<const __nv_bfloat16*>(beta)[c]);
    a[i] = sh_inv[g] * w;
    shift[i] = fmaf(bias[i], a[i], o - sh_mean[g] * a[i]);
  }

  const bool silu = act != 0;
  const int64_t row = (int64_t)b * HW * V + v;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + row;
  uint4* yv = reinterpret_cast<uint4*>(out) + row;
  const int p1 = min(HW, (j + 1) * P);
  int p = j * P + r;
  for (; p + 3 * R < p1; p += 4 * R) {
    const uint4 u0 = xv[(int64_t)p * V];
    const uint4 u1 = xv[(int64_t)(p + R) * V];
    const uint4 u2 = xv[(int64_t)(p + 2 * R) * V];
    const uint4 u3 = xv[(int64_t)(p + 3 * R) * V];
    yv[(int64_t)p * V] = normalise(u0, a, shift, silu);
    yv[(int64_t)(p + R) * V] = normalise(u1, a, shift, silu);
    yv[(int64_t)(p + 2 * R) * V] = normalise(u2, a, shift, silu);
    yv[(int64_t)(p + 3 * R) * V] = normalise(u3, a, shift, silu);
  }
  for (; p < p1; p += R) yv[(int64_t)p * V] = normalise(xv[(int64_t)p * V], a, shift, silu);
}

int threads_for(int C) {
  const int V = C / 8;
  return (kMaxThreads / V > 1 ? kMaxThreads / V : 1) * V;
}

constexpr int kMaxDevices = 64;
int g_resident[kMaxDevices][kMaxThreads + 1];  // 0: not asked yet; a card's answer never changes

// Blocks of both kernels resident on the current card at once, at C / 8
// vectors a pixel (asked once a card and width).
int resident_blocks(int C, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int* cached = dev < kMaxDevices ? &g_resident[dev][C / 8] : nullptr;
  if (cached != nullptr && *cached > 0) {
    *out = *cached;
    return 0;
  }
  int sms = 0, n_stats = 0, n_apply = 0;
  const int T = threads_for(C);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_stats, irt_group_norm_stats_kernel, T, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n_apply, irt_group_norm_apply_kernel, T, 0);
  if (e != cudaSuccess) return (int)e;
  *out = sms * (n_stats < n_apply ? n_stats : n_apply);
  if (cached != nullptr) *cached = *out;
  return 0;
}

}  // namespace

// x, out: [B, HW, C] bf16; gamma, beta: [C] (fp32 where affine_f32, else
// bf16); b1, b2: bf16 [C] (stride 0) or [B, C] (stride C), or null; ws: fp32
// of 2 * B * max_blocks * G. The blocks a row: one wave of the card over the
// B rows, at most max_blocks and at most one a row of R pixels.
extern "C" int irt_group_norm_bf16(const void* x, const void* gamma, const void* beta,
                                   int affine_f32, const void* b1, int s1, const void* b2, int s2,
                                   void* out, void* ws, int B, int HW, int C, int G,
                                   int max_blocks, int act, float eps, void* stream) {
  if (B < 1 || B > 65535 || HW < 1 || C < 8 || C % 8 || C > kMaxChannels || G < 1 ||
      G > kMaxGroups || C % G || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int T = threads_for(C), R = T / (C / 8);
  int slots = 0;
  const int rc = resident_blocks(C, &slots);
  if (rc != 0) return rc;
  int nblk = slots / B;
  nblk = nblk < 1 ? 1 : nblk;
  nblk = nblk < max_blocks ? nblk : max_blocks;
  const int by_pixels = (HW + R - 1) / R;
  nblk = nblk < by_pixels ? nblk : by_pixels;
  const int P = (HW + nblk - 1) / nblk;
  const Terms terms{static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(b2),
                    s1, s2};
  const dim3 grid(nblk, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  irt_group_norm_stats_kernel<<<grid, T, 0, st>>>(static_cast<const __nv_bfloat16*>(x), terms,
                                                  static_cast<float2*>(ws), HW, C, G, R, P);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  irt_group_norm_apply_kernel<<<grid, T, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), gamma, beta, affine_f32, terms,
      static_cast<const float2*>(ws), static_cast<__nv_bfloat16*>(out), HW, C, G, R, P, act, eps);
  return (int)cudaGetLastError();
}
