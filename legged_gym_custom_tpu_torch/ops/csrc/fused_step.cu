// Fused control step for Hopper (sm_90a): K1, K2 and K3 of the port.
//
// Replaces the Pallas TPU kernel legged_gym_custom_tpu/ops/fused_step.py::
// _build_fused (pallas_call :824; body control_step_components :667 ->
// _substep_components :398) with joint damping and armature.  The reference
// specialises at trace time on its spec; here the generated header chooses
// the variant at build time:
//   K1 (LGC_HF_K == 0): penalty contact against the z = 0 plane;
//   K3 (LGC_HF_K > 0):  penalty contact against a bilinear surface read from
//       each env's (K, K) window of the height table (reference
//       _tile_surface :352-395, contact :479-491);
//   K2, two options on either of them:
//       LGC_CONTROL_T: the torque is the scaled action (reference :690-691)
//           instead of the PD law; kp/kd/default angles go unused;
//       LGC_FL_IMPLICIT: implicit stiction (reference :524-527, :633-635).
//           The tanh frictionloss torque is dropped and, after the
//           integration and before the velocity limit, each joint sheds up
//           to DQD = frictionloss * dt_sub / m_eff of velocity toward zero,
//           so a joint inside the dead zone ends at exactly 0.
// One launch runs a whole 50 Hz control step: decimation ticks of clipped PD
// torques, each followed by `substeps` semi-implicit Euler substeps of
// forward kinematics, penalty contact with regularized Coulomb friction,
// joint-limit / viscous / tanh-frictionloss torques and the articulated-body
// algorithm with armature and a 6x6 base solve by 3x3 Schur blocks.  After
// the last substep one more outward kinematics pass over the final state
// writes the report links' world positions and linear velocities (the
// reference's link_states, which it runs in XLA after its kernel).  Device
// memory sees only (C, B) fp32 rows in and out (and for K3 each env's window).
//
// What bounds it on this card.  By the count of operations against bytes the
// step is bound by operations (some 10^5 fp32 operations against ~180 floats
// per env), but at the 4096 envs of a training run it is bound by latency:
// the work of one env is a serial chain (the tree walked outward, inward,
// outward, 16 times), and 4096 chains cannot fill 16896 fp32 lanes.  One
// thread per env put one warp on each SM, with a working set (13 articulated
// inertias of 6x6) that spilled 13-14 KB to local memory on that warp's
// critical path.  The design here shortens the chain and keeps it on chip:
//   * A group of G lanes of a warp runs one env (ops/lane_plan.py).  The
//     tree's branches under the base share nothing until the base, so each
//     lane walks one branch (on a quadruped one leg: 3 bodies, 8 spheres)
//     and a quarter of the base's spheres; with LGC_P_LPB == 2 a pair of
//     lanes shares a branch and splits its spheres.  The lanes meet once a
//     substep: the branches' articulated inertias and bias forces are summed
//     over the group by butterfly shuffles, and every lane then solves the
//     base's 6x6 itself, so the base acceleration needs no broadcast.  All
//     lanes of a warp stay alive to the end; an env beyond B computes on the
//     last env's inputs and only its stores are masked.
//   * Deep chains (LGC_P_SPLIT, LGC_P_LPB == 4; the bipeds' legs of 6): a
//     pair a branch gave 4096 envs 512 warps, one a scheduler, so each
//     dependent step of the 6-slot walk paid its full latency, and both
//     lanes walked the whole inward pass.  Four lanes a branch double the
//     warps; outward each walks the chain and takes a quarter of the
//     spheres, and inward each carries one block of the articulated inertia
//     (I, H or M) through its rank-1 update and rotation, the lanes meeting
//     by shuffles where a step needs another's block.  Registers stay at or
//     under 255 with no spill (2 blocks/SM hold all 256 blocks of 4096 envs
//     at once); per-slot state is not moved to shared memory, since forcing
//     3 blocks/SM only spilled and ran slower on an H100 (PERF.md section 6).
//   * One loop over the slots of a lane, unrolled.  A constant that all
//     lanes share at a slot is a compile-time constant there (LC folds to
//     it); one that differs by lane (the legs mirror each other) is read
//     from a table in shared memory laid out [row][lane].  A joint about a
//     coordinate axis with an identity joint frame (LGC_P_ROTK) is a planar
//     rotation (c, s): vectors and 3x3 blocks are rotated with 4 products a
//     pair of components instead of by a dense 3x3.
//   * Articulated inertias are three 3x3 blocks [[I, H], [H^T, M]], I and M
//     symmetric (21 numbers, not 36).  X^T Ia X for X = (E, p) rotates the
//     blocks by E and shifts them by p with cross products: M' = M~,
//     H' = H~ + p^ M~, I' = I~ + (p^ H~^T)^T + p^ H'^T.  A body's inertia
//     starts from its own constants; the first child assigns its parent's
//     accumulator, the others add.
//   * What lives long and is touched rarely sits in shared memory, laid out
//     [slot][thread] (one warp access covers 32 consecutive floats): the
//     actions and gains, the randomized base inertia, the link-force sums of
//     the last tick and, for K3, each sphere's frozen (h, nx, ny, nz).
//   * K3: each lane samples and keeps only its own spheres' (h, nx, ny, nz),
//     four taps per sphere and tick out of its env's window, which is
//     batch-leading (B, K, K).  The taps are read straight from global
//     memory: copying the block's windows into shared memory first
//     (cp.async) took the same time on an H100 at 4096 envs and twice the
//     shared memory, so it is not kept (PERF.md section 6).  tile_surface's
//     arithmetic is the reference's: the clamp to K - 1.001, the floor, the
//     four taps, the two-stage lerp.
// What still bounds it: with every warp of 4096 envs resident at once, the
// time is that of one lane's chain, the same at 1024 envs; a multiply by a
// constant that is zero in every lane (most joint offsets) is still executed,
// since 0.0f * x is not folded without fast-math.
//
// The robot, the sim constants and the lane plan come from a generated header
// (ops/fused_step.py::spec_header, passed with -include).

#include <cuda_runtime.h>
#include <math.h>

#ifndef LGC_NB
#error "compile with -include <spec header> written by ops/fused_step.py"
#endif
#ifndef LGC_BLOCK
#define LGC_BLOCK 128
#endif

constexpr int NL = LGC_NL;
constexpr int G = LGC_P_G;            // lanes per env
constexpr int LPB = LGC_P_LPB;        // lanes per branch
constexpr int D = LGC_P_DEPTH;        // slots per lane
constexpr int NENT = LGC_P_NENT;      // sphere entries per lane
constexpr int BLOCK = LGC_BLOCK;
constexpr int EPB = BLOCK / G;        // envs per block
static_assert(BLOCK % 32 == 0 && 32 % G == 0, "a group of lanes must not straddle a warp");

// per-thread scratch in shared memory, [slot][thread]
constexpr int SC_ACT = 0;
constexpr int SC_KP = SC_ACT + D;
constexpr int SC_KD = SC_KP + D;
constexpr int SC_M0 = SC_KD + D;              // m0, h0[3], I0 (6: xx xy xz yy yz zz)
constexpr int SC_LF = SC_M0 + 10;             // 3 per sphere entry
constexpr int SC_SURF = SC_LF + 3 * NENT;     // 4 per sphere entry (K3)
constexpr int NSCR = SC_SURF + (LGC_HF_K ? 4 * NENT : 0);

constexpr int FTAB_N = LGC_P_FTAB_ROWS * G;
constexpr int ITAB_N = LGC_P_ITAB_ROWS * G;
constexpr int LFBUF_N = EPB * 3 * NL;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (FTAB_N + NSCR * BLOCK + LFBUF_N) + sizeof(int) * ITAB_N;

__device__ const float FTAB_INIT[FTAB_N] = LGC_P_FTAB;
__device__ const int ITAB_INIT[ITAB_N] = LGC_P_ITAB;

// The plan's constants, declared in every device function that reads them.
#define LGC_PLAN_FIELD(F)                                        \
  constexpr int F##_EQ[LGC_P_##F##_N] = LGC_P_##F##_EQ;          \
  constexpr float F##_VAL[LGC_P_##F##_N] = LGC_P_##F##_VAL;      \
  constexpr int F##_OFF[LGC_P_##F##_N] = LGC_P_##F##_OFF;        \
  (void)F##_EQ; (void)F##_VAL; (void)F##_OFF;
#define LGC_PLAN_CONSTANTS                                                         \
  LGC_PLAN_FIELD(AXIS) LGC_PLAN_FIELD(JROT) LGC_PLAN_FIELD(JPOS)                   \
  LGC_PLAN_FIELD(MASS) LGC_PLAN_FIELD(MH) LGC_PLAN_FIELD(IO) LGC_PLAN_FIELD(DAMP)  \
  LGC_PLAN_FIELD(ARM) LGC_PLAN_FIELD(FL) LGC_PLAN_FIELD(PG) LGC_PLAN_FIELD(DG)     \
  LGC_PLAN_FIELD(DPOS) LGC_PLAN_FIELD(TLIM) LGC_PLAN_FIELD(LO) LGC_PLAN_FIELD(HI)  \
  LGC_PLAN_FIELD(VLIM) LGC_PLAN_FIELD(DQD) LGC_PLAN_FIELD(GPOS)                    \
  LGC_PLAN_FIELD(GRAD) LGC_PLAN_FIELD(LPOS)                                        \
  constexpr int PSLOT[D] = LGC_P_PSLOT;                                            \
  constexpr int FIRST[D] = LGC_P_FIRST;                                            \
  constexpr int HAS_CHILD[D] = LGC_P_HAS_CHILD;                                    \
  constexpr int ROTK[D] = LGC_P_ROTK;                                              \
  constexpr int NSPH[D] = LGC_P_NSPH;                                              \
  constexpr int ENT0[D] = LGC_P_ENT0;                                              \
  constexpr int NLS[D] = LGC_P_NLS;                                                \
  constexpr int LS0[D] = LGC_P_LS0;                                                \
  (void)PSLOT; (void)FIRST; (void)HAS_CHILD; (void)ROTK; (void)NSPH; (void)ENT0;   \
  (void)NLS; (void)LS0;

// Constant F, scalar i, as this lane reads it: the slot's shared value (the
// index is known once the slot loop is unrolled, so this folds) or the lane's
// entry of the table row.  Needs `ftab` and `lane` in scope.
#define LC(F, i) (F##_EQ[i] ? F##_VAL[i] : ftab[F##_OFF[i] * G + lane])
// true at compile time when every lane's F[i] is zero
#define LC_ZERO(F, i) (F##_EQ[i] && F##_VAL[i] == 0.f)

// ---------------------------------------------------------------------------
// 3-vectors, row-major 3x3 matrices, spatial 6-vectors [angular; linear]
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void mv3(const float* M, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}

__device__ __forceinline__ void mtv3(const float* M, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = M[i] * v[0] + M[3 + i] * v[1] + M[6 + i] * v[2];
}

__device__ __forceinline__ void mm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// A B^T
__device__ __forceinline__ void mmt3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
}

// hat(p) A: row r of the result is p x (column-wise), i.e. (p^ A)[:, c] = p x A[:, c]
__device__ __forceinline__ void hat_mm3(const float* p, const float* A, float* C) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    C[c] = p[1] * A[6 + c] - p[2] * A[3 + c];
    C[3 + c] = p[2] * A[c] - p[0] * A[6 + c];
    C[6 + c] = p[0] * A[3 + c] - p[1] * A[c];
  }
}

// hat(p) A^T
__device__ __forceinline__ void hat_mmt3(const float* p, const float* A, float* C) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    C[c] = p[1] * A[3 * c + 2] - p[2] * A[3 * c + 1];
    C[3 + c] = p[2] * A[3 * c] - p[0] * A[3 * c + 2];
    C[6 + c] = p[0] * A[3 * c + 1] - p[1] * A[3 * c];
  }
}

// fill the lower triangle of a symmetric 3x3 from its upper one
__device__ __forceinline__ void symmetrize(float* A) {
  A[3] = A[1];
  A[6] = A[2];
  A[7] = A[5];
}

// ---------------------------------------------------------------------------
// A slot's joint rotation E (child <- parent).  k >= 0: a planar rotation by
// (c, s) about coordinate axis k, E[k][k] = 1, E[i][i] = E[j][j] = c,
// E[i][j] = s, E[j][i] = -s with (k, i, j) cyclic, and E[] is not read;
// k < 0: the dense matrix E.  k is a compile-time constant at every call.
// ---------------------------------------------------------------------------

// o = E x
__device__ __forceinline__ void rot_mv(int k, float c, float s, const float* E, const float* x,
                                       float* o) {
  if (k >= 0) {
    const int i = (k + 1) % 3, j = (k + 2) % 3;
    o[k] = x[k];
    o[i] = c * x[i] + s * x[j];
    o[j] = c * x[j] - s * x[i];
  } else {
    mv3(E, x, o);
  }
}

// o = E^T x
__device__ __forceinline__ void rot_mtv(int k, float c, float s, const float* E, const float* x,
                                        float* o) {
  if (k >= 0) {
    const int i = (k + 1) % 3, j = (k + 2) % 3;
    o[k] = x[k];
    o[i] = c * x[i] - s * x[j];
    o[j] = c * x[j] + s * x[i];
  } else {
    mtv3(E, x, o);
  }
}

// O = E A
__device__ __forceinline__ void rot_mm(int k, float c, float s, const float* E, const float* A,
                                       float* O) {
  if (k >= 0) {
    const int i = (k + 1) % 3, j = (k + 2) % 3;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      O[3 * k + t] = A[3 * k + t];
      O[3 * i + t] = c * A[3 * i + t] + s * A[3 * j + t];
      O[3 * j + t] = c * A[3 * j + t] - s * A[3 * i + t];
    }
  } else {
    mm3(E, A, O);
  }
}

// O = E^T A E
__device__ __forceinline__ void rot_sandwich(int k, float c, float s, const float* E,
                                             const float* A, float* O) {
  float T[9];
  if (k >= 0) {
    const int i = (k + 1) % 3, j = (k + 2) % 3;
#pragma unroll
    for (int r = 0; r < 3; ++r) {   // T = A E: each row of A through E^T
      T[3 * r + k] = A[3 * r + k];
      T[3 * r + i] = c * A[3 * r + i] - s * A[3 * r + j];
      T[3 * r + j] = c * A[3 * r + j] + s * A[3 * r + i];
    }
#pragma unroll
    for (int t = 0; t < 3; ++t) {   // O = E^T T
      O[3 * k + t] = T[3 * k + t];
      O[3 * i + t] = c * T[3 * i + t] - s * T[3 * j + t];
      O[3 * j + t] = c * T[3 * j + t] + s * T[3 * i + t];
    }
  } else {
    mm3(A, E, T);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int t = 0; t < 3; ++t)
        O[3 * r + t] = E[r] * T[t] + E[3 + r] * T[3 + t] + E[6 + r] * T[6 + t];
  }
}

// motion transform X = (E, p): [E w; E (v - p x w)]
__device__ __forceinline__ void xform_motion(int k, float c, float s, const float* E,
                                             const float* p, const float* m, float* o) {
  float pxw[3], t[3];
  cross3(p, m, pxw);
  t[0] = m[3] - pxw[0];
  t[1] = m[4] - pxw[1];
  t[2] = m[5] - pxw[2];
  rot_mv(k, c, s, E, m, o);
  rot_mv(k, c, s, E, t, o + 3);
}

// inverse force transform: [E^T n + p x (E^T f); E^T f]
__device__ __forceinline__ void inv_xform_force(int k, float c, float s, const float* E,
                                                const float* p, const float* f, float* o) {
  float n[3], pxf[3];
  rot_mtv(k, c, s, E, f, n);
  rot_mtv(k, c, s, E, f + 3, o + 3);
  cross3(p, o + 3, pxf);
  o[0] = n[0] + pxf[0];
  o[1] = n[1] + pxf[1];
  o[2] = n[2] + pxf[2];
}

// spatial force cross product v x* f
__device__ __forceinline__ void crf(const float* v, const float* f, float* o) {
  float a[3], b[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  o[0] = a[0] + b[0];
  o[1] = a[1] + b[1];
  o[2] = a[2] + b[2];
  cross3(v, f + 3, o + 3);
}

// spatial inertia (m, h, I about the body origin) applied to motion v
__device__ __forceinline__ void inertia_mul(float m, const float* h, const float* I,
                                            const float* v, float* o) {
  float a[3], b[3];
  mv3(I, v, o);
  cross3(h, v + 3, a);
  o[0] += a[0];
  o[1] += a[1];
  o[2] += a[2];
  cross3(h, v, b);
  o[3] = v[3] * m - b[0];
  o[4] = v[4] * m - b[1];
  o[5] = v[5] * m - b[2];
}

// gravity in a body's frame, g_b = E g; only its z component is set in practice
__device__ __forceinline__ void gravity_body(const float* E, float* g_b) {
  constexpr float GRAV[3] = LGC_GRAVITY;
  if (GRAV[0] == 0.f && GRAV[1] == 0.f) {
#pragma unroll
    for (int i = 0; i < 3; ++i) g_b[i] = E[3 * i + 2] * GRAV[2];
  } else {
    mv3(E, GRAV, g_b);
  }
}

__device__ __forceinline__ void inv3(const float* M, float* o) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5], g = M[6], h = M[7],
              i = M[8];
  const float A = e * i - f * h, B = c * h - b * i, C = b * f - c * e;
  const float D_ = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
  const float G_ = d * h - e * g, H = b * g - a * h, I = a * e - b * d;
  const float inv_det = 1.0f / (a * A + b * D_ + c * G_);
  o[0] = A * inv_det; o[1] = B * inv_det; o[2] = C * inv_det;
  o[3] = D_ * inv_det; o[4] = E * inv_det; o[5] = F * inv_det;
  o[6] = G_ * inv_det; o[7] = H * inv_det; o[8] = I * inv_det;
}

// SPD 6x6 solve [[A11, A12], [A12^T, A22]] x = b via 3x3 Schur blocks
// (reference soa.solve66)
__device__ __forceinline__ void solve66(const float* A11, const float* A12, const float* A22,
                                        const float* b, float* x) {
  float A21[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) A21[3 * i + j] = A12[3 * j + i];
  float A11i[9], T[9], S[9], Si[9];
  inv3(A11, A11i);
  mm3(A11i, A12, T);
  mm3(A21, T, S);
#pragma unroll
  for (int k = 0; k < 9; ++k) S[k] = A22[k] - S[k];
  inv3(S, Si);
  float t1[3], t2[3], r[3];
  mv3(A11i, b, t1);
  mv3(A21, t1, t2);
  r[0] = b[3] - t2[0];
  r[1] = b[4] - t2[1];
  r[2] = b[5] - t2[2];
  mv3(Si, r, x + 3);
  mv3(A12, x + 3, t2);
  r[0] = b[0] - t2[0];
  r[1] = b[1] - t2[1];
  r[2] = b[2] - t2[2];
  mv3(A11i, r, x);
}

#if LGC_HF_K
// ---------------------------------------------------------------------------
// Bilinear height and unit normal from one env's (K, K) window (reference
// _tile_surface): grid coordinates clamped to [0, K - 1.001], floor and
// fractions, then the four taps the reference's one-hot contraction weights.
// out = (h, nx, ny, nz).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tile_surface(const float* __restrict__ P, float xoff, float yoff,
                                             float cx, float cy, float* out) {
  constexpr int K = LGC_HF_K;
  constexpr float inv_hs = LGC_HF_INV_HS;
  const float gx = fminf(fmaxf((cx - xoff) * inv_hs, 0.f), LGC_HF_GMAX);
  const float gy = fminf(fmaxf((cy - yoff) * inv_hs, 0.f), LGC_HF_GMAX);
  const float x0f = floorf(gx), y0f = floorf(gy);
  const float fx = gx - x0f, fy = gy - y0f;
  // the index clamp only acts on a NaN coordinate
  const int x0 = min(max(static_cast<int>(x0f), 0), K - 2);
  const int y0 = min(max(static_cast<int>(y0f), 0), K - 2);
  const float* r0 = P + x0 * K + y0;
  const float p00 = r0[0], p01 = r0[1], p10 = r0[K], p11 = r0[K + 1];
  const float u0 = (1.f - fx) * p00 + fx * p10;  // sum_i Wx[i] P[i, y0]
  const float u1 = (1.f - fx) * p01 + fx * p11;  // sum_i Wx[i] P[i, y0 + 1]
  const float h = (1.f - fy) * u0 + fy * u1;
  const float dhdx = ((1.f - fy) * (p10 - p00) + fy * (p11 - p01)) * inv_hs;
  const float dhdy = (u1 - u0) * inv_hs;
  const float inv_norm = 1.0f / sqrtf(dhdx * dhdx + dhdy * dhdy + 1.0f);
  out[0] = h;
  out[1] = -dhdx * inv_norm;
  out[2] = -dhdy * inv_norm;
  out[3] = inv_norm;
}
#endif

// ---------------------------------------------------------------------------
// Slot bookkeeping.  `ps` is the parent slot (-1 the base), a compile-time
// constant when the plan's parent slots are the same in all lanes, so the
// loops below fold to one copy; else it is the lane's own and they become
// a chain of selects.
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void pick(float* out, const float* base, const float (*slots)[N],
                                     int s, int ps) {
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = base[k];
#pragma unroll
  for (int t = 0; t < D; ++t)
    if (t < s && ps == t) {
#pragma unroll
      for (int k = 0; k < N; ++k) out[k] = slots[t][k];
    }
}

// acc[ps + 1] (0 is the base) takes x: assigned when `first`, else added
template <int N>
__device__ __forceinline__ void give(float (*acc)[N], int s, int ps, bool first, const float* x) {
#pragma unroll
  for (int t = 0; t <= D; ++t)
    if (t <= s && ps + 1 == t) {
#pragma unroll
      for (int k = 0; k < N; ++k) acc[t][k] = first ? x[k] : acc[t][k] + x[k];
    }
}

// ---------------------------------------------------------------------------
// The outward kinematics (reference forward_kinematics), shared by the
// substep and the link-state pass.  `base_frame`: the base's rotation R
// (world <- base), E0b = R^T and spatial velocity v0 in base coords.
// `parent_slots`: each slot's parent slot.  `slot_kinematics`: slot s's
// joint (c, s) and, for a dense joint, E_up; its body's rotation E0 (body
// <- world), origin p0 relative to the base origin in world axes, and
// spatial velocity v in body coords with the joint's velocity added.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void base_frame(const float* quat, const float* lin, const float* ang,
                                           float* R, float* E0b, float* v0) {
  const float w = quat[0], x = quat[1], y = quat[2], z = quat[3];
  R[0] = 1.f - 2.f * (y * y + z * z); R[1] = 2.f * (x * y - w * z); R[2] = 2.f * (x * z + w * y);
  R[3] = 2.f * (x * y + w * z); R[4] = 1.f - 2.f * (x * x + z * z); R[5] = 2.f * (y * z - w * x);
  R[6] = 2.f * (x * z - w * y); R[7] = 2.f * (y * z + w * x); R[8] = 1.f - 2.f * (x * x + y * y);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) E0b[3 * r + c] = R[3 * c + r];
  mtv3(R, ang, v0);
  mtv3(R, lin, v0 + 3);
}

__device__ __forceinline__ void parent_slots(const int* itab, int lane, int* ps) {
  LGC_PLAN_CONSTANTS
  constexpr bool UNIFORM = LGC_P_PSLOT_UNIFORM;
  (void)itab;
#pragma unroll
  for (int s = 0; s < D; ++s) ps[s] = UNIFORM ? PSLOT[s] : itab[(LGC_P_ROW_PSLOT + s) * G + lane];
}

__device__ __forceinline__ void slot_kinematics(int s, int ps, const float* E0b, const float* v0,
                                                const float* q, const float* qd,
                                                const float* ftab, int lane, float (*E0)[9],
                                                float (*p0)[3], float (*Eup)[9], float* rc,
                                                float* rs, float (*v)[6]) {
  LGC_PLAN_CONSTANTS
  const int k = ROTK[s];
  const float zero3[3] = {0.f, 0.f, 0.f};
  float Ep[9], pp[3], vp[6];
  pick<9>(Ep, E0b, E0, s, ps);
  pick<3>(pp, zero3, p0, s, ps);
  pick<6>(vp, v0, v, s, ps);
  const float a[3] = {LC(AXIS, 3 * s), LC(AXIS, 3 * s + 1), LC(AXIS, 3 * s + 2)};
  sincosf(q[s], &rs[s], &rc[s]);
  if (k < 0) {
    const float cq = rc[s], sq = rs[s];
    const float ax[9] = {0.f, -a[2], a[1], a[2], 0.f, -a[0], -a[1], a[0], 0.f};
    float Ej[9], JR[9];  // E_j = R(axis, q)^T
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        Ej[3 * c + r] = (r == c ? cq : 0.f) + sq * ax[3 * r + c] + (1.f - cq) * (a[r] * a[c]);
#pragma unroll
    for (int t = 0; t < 9; ++t) JR[t] = LC(JROT, 9 * s + t);
    mm3(Ej, JR, Eup[s]);
  }
  rot_mm(k, rc[s], rs[s], Eup[s], Ep, E0[s]);
  const float jp[3] = {LC(JPOS, 3 * s), LC(JPOS, 3 * s + 1), LC(JPOS, 3 * s + 2)};
  float t3[3];
  mtv3(Ep, jp, t3);
#pragma unroll
  for (int i = 0; i < 3; ++i) p0[s][i] = pp[i] + t3[i];
  xform_motion(k, rc[s], rs[s], Eup[s], jp, vp, v[s]);
  // the joint's velocity a qd
  if (k >= 0) {
    v[s][k] += qd[s];
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) v[s][i] += a[i] * qd[s];
  }
}

// ---------------------------------------------------------------------------
// One sphere entry of a body at (E0, p0, v): adds its (torque, force), world
// axes about the body origin, to w6 and, in the last tick, its force to the
// entry's link-force sum.  K3 reads the tick's frozen surface from the
// entry's scratch and, when `sample_now` (the tick's first substep), samples
// it there first.  An entry no geom fills has a radius that never touches and
// adds exactly zero.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void sphere_contact(int e, const float* E0, const float* p0,
                                               const float* v, const float* pos, float mu,
                                               const float* ftab, int lane, float* scr,
                                               const float* __restrict__ win, float xoff,
                                               float yoff, bool sample_now, bool last_tick,
                                               float* w6) {
  LGC_PLAN_CONSTANTS
  const float gp[3] = {LC(GPOS, 3 * e), LC(GPOS, 3 * e + 1), LC(GPOS, 3 * e + 2)};
  const float radius = LC(GRAD, e);
  float off[3], wxg[3], vel_b[3], vel_w[3];
  mtv3(E0, gp, off);
  const float cz = pos[2] + p0[2] + off[2];
  cross3(v, gp, wxg);
  vel_b[0] = v[3] + wxg[0];
  vel_b[1] = v[4] + wxg[1];
  vel_b[2] = v[5] + wxg[2];
  mtv3(E0, vel_b, vel_w);
#if LGC_HF_K
  float* sg = scr + (SC_SURF + 4 * e) * BLOCK;
  if (sample_now) {
    float sample[4];
    tile_surface(win, xoff, yoff, pos[0] + p0[0] + off[0], pos[1] + p0[1] + off[1], sample);
#pragma unroll
    for (int k = 0; k < 4; ++k) sg[k * BLOCK] = sample[k];
  }
  const float h = sg[0], nx = sg[BLOCK], ny = sg[2 * BLOCK], nz = sg[3 * BLOCK];
  const float depth = radius - nz * (cz - h);
  const float vn = vel_w[0] * nx + vel_w[1] * ny + vel_w[2] * nz;
  const float vt[3] = {vel_w[0] - vn * nx, vel_w[1] - vn * ny, vel_w[2] - vn * nz};
  float fn = fmaxf(LGC_STIFFNESS * depth - LGC_DAMPING * vn, 0.f);
  fn = depth > 0.f ? fn : 0.f;
  const float vt_norm = sqrtf(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2]);
  const float ft_mag = fminf(LGC_FRICTION_VEL * vt_norm, mu * fn);
  const float inv_vt = ft_mag / (vt_norm + 1e-6f);
  const float force[3] = {fn * nx - vt[0] * inv_vt, fn * ny - vt[1] * inv_vt,
                          fn * nz - vt[2] * inv_vt};
#else
  (void)win; (void)xoff; (void)yoff; (void)sample_now;
  const float depth = radius - cz;
  const float vn = vel_w[2];
  float fn = fmaxf(LGC_STIFFNESS * depth - LGC_DAMPING * vn, 0.f);
  fn = depth > 0.f ? fn : 0.f;
  const float vt_norm = sqrtf(vel_w[0] * vel_w[0] + vel_w[1] * vel_w[1]);
  const float ft_mag = fminf(LGC_FRICTION_VEL * vt_norm, mu * fn);
  const float inv_vt = ft_mag / (vt_norm + 1e-6f);
  const float force[3] = {-vel_w[0] * inv_vt, -vel_w[1] * inv_vt, fn};
#endif
  float torque[3];
  cross3(off, force, torque);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w6[k] += torque[k];
    w6[3 + k] += force[k];
  }
  if (last_tick) {
#pragma unroll
    for (int k = 0; k < 3; ++k) scr[(SC_LF + 3 * e + k) * BLOCK] += force[k];
  }
}

// ---------------------------------------------------------------------------
// One semi-implicit Euler substep (reference _substep_components) of this
// lane's slots and its share of the base.  pos, quat, lin, ang are the base's
// and identical in all lanes of the group, before and after.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void substep(float* pos, float* quat, float* lin, float* ang, float* q,
                                        float* qd, const float* tau, float mu, const float* ftab,
                                        const int* itab, int lane, float* scr,
                                        const float* __restrict__ win, float xoff, float yoff,
                                        bool sample_now, bool last_tick) {
  LGC_PLAN_CONSTANTS
  constexpr float dt = LGC_DT_SUB;
  constexpr bool UNIFORM = LGC_P_PSLOT_UNIFORM;
  (void)itab;

  // base rotation (world <- base) and spatial velocity in base coords
  float R[9], E0b[9], v0[6];
  base_frame(quat, lin, ang, R, E0b, v0);
  const float zero3[3] = {0.f, 0.f, 0.f};
  int ps[D];   // parent slot of each slot
  parent_slots(itab, lane, ps);

  // ---- outward: kinematics, each body's contacts, bias force and joint torque
  float E0[D][9], p0[D][3], Eup[D][9], rc[D], rs[D], v[D][6], cb[D][6], pA[D][6], tt[D];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    const int k = ROTK[s];
    slot_kinematics(s, ps[s], E0b, v0, q, qd, ftab, lane, E0, p0, Eup, rc, rs, v);
    // c = v x [a qd; 0]
    if (k >= 0) {
      const int i = (k + 1) % 3, j = (k + 2) % 3;
      cb[s][k] = 0.f;
      cb[s][i] = v[s][j] * qd[s];
      cb[s][j] = -(v[s][i] * qd[s]);
      cb[s][3 + k] = 0.f;
      cb[s][3 + i] = v[s][3 + j] * qd[s];
      cb[s][3 + j] = -(v[s][3 + i] * qd[s]);
    } else {
      float aq[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) aq[i] = LC(AXIS, 3 * s + i) * qd[s];
      cross3(v[s], aq, cb[s]);
      cross3(v[s] + 3, aq, cb[s] + 3);
    }

    // penalty contact of this body's spheres (the plane, or the tick's surface)
    float wr[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < LGC_P_MAX_NSPH; ++i)
      if (i < NSPH[s])
        sphere_contact(ENT0[s] + i, E0[s], p0[s], v[s], pos, mu, ftab, lane, scr, win, xoff, yoff,
                       sample_now, last_tick, wr);
#pragma unroll
    for (int m = 1; m < LPB; m <<= 1)   // the lanes of a branch split its spheres
#pragma unroll
      for (int i = 0; i < 6; ++i) wr[i] += __shfl_xor_sync(0xffffffffu, wr[i], m);

    // bias force pA = v x* (I v) - [h x g; m g] - [E0 n; E0 f]
    {
      const float m = LC(MASS, s);
      const float h[3] = {LC(MH, 3 * s), LC(MH, 3 * s + 1), LC(MH, 3 * s + 2)};
      float I[9];
      I[0] = LC(IO, 6 * s); I[1] = LC(IO, 6 * s + 1); I[2] = LC(IO, 6 * s + 2);
      I[4] = LC(IO, 6 * s + 3); I[5] = LC(IO, 6 * s + 4); I[8] = LC(IO, 6 * s + 5);
      symmetrize(I);
      float Iv[6], pa[6], g_b[3], hxg[3], n_b[3], f_b[3];
      inertia_mul(m, h, I, v[s], Iv);
      crf(v[s], Iv, pa);
      gravity_body(E0[s], g_b);
      cross3(h, g_b, hxg);
      mv3(E0[s], wr, n_b);
      mv3(E0[s], wr + 3, f_b);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pA[s][i] = pa[i] - hxg[i] - n_b[i];
        pA[s][3 + i] = pa[3 + i] - m * g_b[i] - f_b[i];
      }
    }

    // joint-limit torque + passive joint dynamics
    {
      const float below = fminf(q[s] - LC(LO, s), 0.f);
      const float above = fmaxf(q[s] - LC(HI, s), 0.f);
      const bool viol = (below < 0.f) || (above > 0.f);
      float t = tau[s] + (-LGC_JL_STIFFNESS * (below + above) - (viol ? LGC_JL_DAMPING * qd[s] : 0.f));
      if (!LC_ZERO(DAMP, s)) t = t - LC(DAMP, s) * qd[s];
#if !LGC_FL_IMPLICIT
      // tanh surrogate; implicit stiction clamps the velocity after the
      // integration instead
      if (!LC_ZERO(FL, s)) t = t - LC(FL, s) * tanhf(qd[s] * LGC_INV_FL_EPS);
#endif
      tt[s] = t;
    }
  }

  // the base's own spheres, dealt over the lanes of the group
  float wb[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < LGC_P_NSPH_BASE; ++i)
    sphere_contact(LGC_P_ENT0_BASE + i, E0b, zero3, v0, pos, mu, ftab, lane, scr, win, xoff, yoff,
                   sample_now, last_tick, wb);

#if LGC_P_SPLIT
  // ---- inward, the layout for deep chains: the LPB = 4 lanes of a branch
  // each carry one block of the articulated inertia [[I, H], [H^T, M]] (the
  // lane's `role`: 0 I, 1 H, 2 M; 3 repeats M and adds nothing) through its
  // rank-1 update and rotation, and meet by shuffles where a step needs
  // another lane's block: U = IA [a; 0] takes I a from role 0 and H^T a from
  // role 1, the bias force sums the lanes' shares of Ia c, and the shift to
  // the parent takes M~ and H~ from roles 2 and 1.  The bias force, U, d and
  // u are computed alike in all four lanes (identical inputs, identical bits).
  const int role = lane % LPB;
  const int blk = role < 2 ? role : 2;
  const int lead = (static_cast<int>(threadIdx.x) & 31) - role;   // the branch's role-0 lane
  float cX[D + 1][9], cP[D + 1][6];
  if (!UNIFORM) {
#pragma unroll
    for (int t = 0; t <= D; ++t) {
#pragma unroll
      for (int i = 0; i < 9; ++i) cX[t][i] = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) cP[t][i] = 0.f;
    }
  }
  float Uw[D][3], Uv[D][3], inv_d[D], u[D];
#pragma unroll
  for (int s = D - 1; s >= 0; --s) {
    const int k = ROTK[s];
    const float m = LC(MASS, s);
    const float h[3] = {LC(MH, 3 * s), LC(MH, 3 * s + 1), LC(MH, 3 * s + 2)};
    // this lane's block: the body's own (I about the origin, hat(m h), m 1)
    // plus its children's
    float X[9], pa[6];
    {
      float Io[9];
      Io[0] = LC(IO, 6 * s); Io[1] = LC(IO, 6 * s + 1); Io[2] = LC(IO, 6 * s + 2);
      Io[4] = LC(IO, 6 * s + 3); Io[5] = LC(IO, 6 * s + 4); Io[8] = LC(IO, 6 * s + 5);
      symmetrize(Io);
      const float Hc[9] = {0.f, -h[2], h[1], h[2], 0.f, -h[0], -h[1], h[0], 0.f};
      const float Mc[9] = {m, 0.f, 0.f, 0.f, m, 0.f, 0.f, 0.f, m};
#pragma unroll
      for (int i = 0; i < 9; ++i) X[i] = blk == 0 ? Io[i] : (blk == 1 ? Hc[i] : Mc[i]);
    }
    if (HAS_CHILD[s] || !UNIFORM) {
#pragma unroll
      for (int i = 0; i < 9; ++i) X[i] += cX[s + 1][i];
#pragma unroll
      for (int i = 0; i < 6; ++i) pa[i] = pA[s][i] + cP[s + 1][i];
    } else {
#pragma unroll
      for (int i = 0; i < 6; ++i) pa[i] = pA[s][i];
    }

    // U = IA [a; 0]: I a from role 0, H^T a from role 1; d = a.U + armature,
    // u = tau - a.pA
    float Xa[3], Xta[3];
    if (k >= 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        Xa[i] = X[3 * i + k];
        Xta[i] = X[3 * k + i];
      }
    } else {
      const float a[3] = {LC(AXIS, 3 * s), LC(AXIS, 3 * s + 1), LC(AXIS, 3 * s + 2)};
      mv3(X, a, Xa);
      mtv3(X, a, Xta);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Uw[s][i] = __shfl_sync(0xffffffffu, Xa[i], lead);
      Uv[s][i] = __shfl_sync(0xffffffffu, Xta[i], lead + 1);
    }
    float adotU, adotp;
    if (k >= 0) {
      adotU = Uw[s][k];
      adotp = pa[k];
    } else {
      const float a[3] = {LC(AXIS, 3 * s), LC(AXIS, 3 * s + 1), LC(AXIS, 3 * s + 2)};
      adotU = a[0] * Uw[s][0] + a[1] * Uw[s][1] + a[2] * Uw[s][2];
      adotp = a[0] * pa[0] + a[1] * pa[1] + a[2] * pa[2];
    }
    const float d = adotU + LC(ARM, s);
    u[s] = tt[s] - adotp;
    inv_d[s] = 1.0f / d;
    const float idg = inv_d[s];

    // this lane's block of Ia = IA - U U^T / d: I - Uw Uw^T, H - Uw Uv^T,
    // M - Uv Uv^T (over d)
    float Xn[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float lr = blk == 2 ? Uv[s][r] : Uw[s][r];
        const float rc_ = blk == 0 ? Uw[s][c] : Uv[s][c];
        Xn[3 * r + c] = X[3 * r + c] - lr * rc_ * idg;
      }

    // pa2 = pA + Ia c + U u / d; this lane's share of Ia c: [I cw; 0],
    // [H cv; H^T cw] or [0; M cv], summed over the branch's lanes
    float part[6];
    {
      float y1[3], y2[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        y1[i] = role == 0 ? cb[s][i] : (role == 1 ? cb[s][3 + i] : 0.f);
        y2[i] = role == 1 ? cb[s][i] : (role == 2 ? cb[s][3 + i] : 0.f);
      }
      mv3(Xn, y1, part);
      mtv3(Xn, y2, part + 3);
    }
#pragma unroll
    for (int mk = 1; mk < LPB; mk <<= 1)
#pragma unroll
      for (int i = 0; i < 6; ++i) part[i] += __shfl_xor_sync(0xffffffffu, part[i], mk);
    float pa2[6];
    {
      const float uid = u[s] * idg;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pa2[i] = pa[i] + part[i] + Uw[s][i] * uid;
        pa2[3 + i] = pa[3 + i] + part[3 + i] + Uv[s][i] * uid;
      }
    }

    // to the parent: each lane rotates its block by E; then the shift by p,
    // H' = H~ + p^ M~ and I' = I~ + (p^ H~^T)^T + p^ H'^T, with M~ and H~
    // from their lanes
    const float jp[3] = {LC(JPOS, 3 * s), LC(JPOS, 3 * s + 1), LC(JPOS, 3 * s + 2)};
    float Xt[9], Ht[9], Mt[9], Hp[9], A[9], Bm[9], Xp[9], fp[6];
    rot_sandwich(k, rc[s], rs[s], Eup[s], Xn, Xt);
    // the symmetric blocks' lower triangles from their upper ones
    Xt[3] = blk == 1 ? Xt[3] : Xt[1];
    Xt[6] = blk == 1 ? Xt[6] : Xt[2];
    Xt[7] = blk == 1 ? Xt[7] : Xt[5];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      Ht[i] = __shfl_sync(0xffffffffu, Xt[i], lead + 1);
      Mt[i] = __shfl_sync(0xffffffffu, Xt[i], lead + 2);
    }
    hat_mm3(jp, Mt, Hp);
#pragma unroll
    for (int i = 0; i < 9; ++i) Hp[i] += Ht[i];
    hat_mmt3(jp, Ht, A);
    hat_mmt3(jp, Hp, Bm);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = r; c < 3; ++c) {
        const float ip = Xt[3 * r + c] + A[3 * c + r] + Bm[3 * r + c];
        Xp[3 * r + c] = blk == 0 ? ip : (blk == 1 ? Hp[3 * r + c] : Xt[3 * r + c]);
        if (c > r) Xp[3 * c + r] = blk == 0 ? ip : (blk == 1 ? Hp[3 * c + r] : Xt[3 * c + r]);
      }
    inv_xform_force(k, rc[s], rs[s], Eup[s], jp, pa2, fp);
    const bool first = UNIFORM && FIRST[s];
    give<9>(cX, s, ps[s], first, Xp);
    give<6>(cP, s, ps[s], first, fp);
  }

  // ---- the base: each block and the bias force summed over the group's
  // branches (a lane with the lanes of its role), then every lane takes the
  // blocks from its branch's lanes
#pragma unroll
  for (int m = LPB; m < G; m <<= 1) {
#pragma unroll
    for (int i = 0; i < 9; ++i) cX[0][i] += __shfl_xor_sync(0xffffffffu, cX[0][i], m);
#pragma unroll
    for (int i = 0; i < 6; ++i) cP[0][i] += __shfl_xor_sync(0xffffffffu, cP[0][i], m);
  }
  float ci[9], ch[9], cm[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    ci[i] = __shfl_sync(0xffffffffu, cX[0][i], lead);
    ch[i] = __shfl_sync(0xffffffffu, cX[0][i], lead + 1);
    cm[i] = __shfl_sync(0xffffffffu, cX[0][i], lead + 2);
  }
  const float* cp = cP[0];
#else
  // ---- inward: articulated inertias as blocks (I, H, M), children into parents
  float cI[D + 1][9], cH[D + 1][9], cM[D + 1][9], cP[D + 1][6];
  if (!UNIFORM) {
#pragma unroll
    for (int t = 0; t <= D; ++t) {
#pragma unroll
      for (int i = 0; i < 9; ++i) cI[t][i] = cH[t][i] = cM[t][i] = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i) cP[t][i] = 0.f;
    }
  }
  float Uw[D][3], Uv[D][3], inv_d[D], u[D];
#pragma unroll
  for (int s = D - 1; s >= 0; --s) {
    const int k = ROTK[s];
    const float m = LC(MASS, s);
    const float h[3] = {LC(MH, 3 * s), LC(MH, 3 * s + 1), LC(MH, 3 * s + 2)};
    float I[9], H[9], M[9], pa[6];
    I[0] = LC(IO, 6 * s); I[1] = LC(IO, 6 * s + 1); I[2] = LC(IO, 6 * s + 2);
    I[4] = LC(IO, 6 * s + 3); I[5] = LC(IO, 6 * s + 4); I[8] = LC(IO, 6 * s + 5);
    if (HAS_CHILD[s] || !UNIFORM) {
      const float* ci = cI[s + 1];
      const float* ch = cH[s + 1];
      const float* cm = cM[s + 1];
      I[0] += ci[0]; I[1] += ci[1]; I[2] += ci[2]; I[4] += ci[4]; I[5] += ci[5]; I[8] += ci[8];
      H[0] = ch[0]; H[1] = ch[1] - h[2]; H[2] = ch[2] + h[1];
      H[3] = ch[3] + h[2]; H[4] = ch[4]; H[5] = ch[5] - h[0];
      H[6] = ch[6] - h[1]; H[7] = ch[7] + h[0]; H[8] = ch[8];
      M[0] = cm[0] + m; M[1] = cm[1]; M[2] = cm[2]; M[4] = cm[4] + m; M[5] = cm[5];
      M[8] = cm[8] + m;
#pragma unroll
      for (int i = 0; i < 6; ++i) pa[i] = pA[s][i] + cP[s + 1][i];
    } else {
      H[0] = 0.f; H[1] = -h[2]; H[2] = h[1];
      H[3] = h[2]; H[4] = 0.f; H[5] = -h[0];
      H[6] = -h[1]; H[7] = h[0]; H[8] = 0.f;
      M[0] = m; M[1] = 0.f; M[2] = 0.f; M[4] = m; M[5] = 0.f; M[8] = m;
#pragma unroll
      for (int i = 0; i < 6; ++i) pa[i] = pA[s][i];
    }
    symmetrize(I);
    symmetrize(M);

    // U = IA [a; 0], d = a.U + armature, u = tau - a.pA
    float adotU, adotp;
    if (k >= 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        Uw[s][i] = I[3 * i + k];
        Uv[s][i] = H[3 * k + i];
      }
      adotU = Uw[s][k];
      adotp = pa[k];
    } else {
      const float a[3] = {LC(AXIS, 3 * s), LC(AXIS, 3 * s + 1), LC(AXIS, 3 * s + 2)};
      mv3(I, a, Uw[s]);
      mtv3(H, a, Uv[s]);
      adotU = a[0] * Uw[s][0] + a[1] * Uw[s][1] + a[2] * Uw[s][2];
      adotp = a[0] * pa[0] + a[1] * pa[1] + a[2] * pa[2];
    }
    const float d = adotU + LC(ARM, s);
    u[s] = tt[s] - adotp;
    inv_d[s] = 1.0f / d;
    const float idg = inv_d[s];

    // Ia = IA - U U^T / d
    float In[9], Hn[9], Mn[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Hn[3 * r + c] = H[3 * r + c] - Uw[s][r] * Uv[s][c] * idg;
        if (c >= r) {
          In[3 * r + c] = I[3 * r + c] - Uw[s][r] * Uw[s][c] * idg;
          Mn[3 * r + c] = M[3 * r + c] - Uv[s][r] * Uv[s][c] * idg;
        }
      }
    symmetrize(In);
    symmetrize(Mn);

    // pa2 = pA + Ia c + U u / d
    float pa2[6];
    {
      float t1[3], t2[3], t3[3], t4[3];
      const float uid = u[s] * idg;
      mv3(In, cb[s], t1);
      mv3(Hn, cb[s] + 3, t2);
      mtv3(Hn, cb[s], t3);
      mv3(Mn, cb[s] + 3, t4);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pa2[i] = pa[i] + (t1[i] + t2[i]) + Uw[s][i] * uid;
        pa2[3 + i] = pa[3 + i] + (t3[i] + t4[i]) + Uv[s][i] * uid;
      }
    }

    // to the parent: rotate the blocks by E, then shift them by p
    const float jp[3] = {LC(JPOS, 3 * s), LC(JPOS, 3 * s + 1), LC(JPOS, 3 * s + 2)};
    float It[9], Ht[9], Mt[9], Hp[9], A[9], Bm[9], Ip[9], fp[6];
    rot_sandwich(k, rc[s], rs[s], Eup[s], In, It);
    rot_sandwich(k, rc[s], rs[s], Eup[s], Hn, Ht);
    rot_sandwich(k, rc[s], rs[s], Eup[s], Mn, Mt);
    symmetrize(Mt);
    hat_mm3(jp, Mt, Hp);
#pragma unroll
    for (int i = 0; i < 9; ++i) Hp[i] += Ht[i];
    hat_mmt3(jp, Ht, A);
    hat_mmt3(jp, Hp, Bm);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = r; c < 3; ++c) Ip[3 * r + c] = It[3 * r + c] + A[3 * c + r] + Bm[3 * r + c];
    symmetrize(Ip);
    inv_xform_force(k, rc[s], rs[s], Eup[s], jp, pa2, fp);
    const bool first = UNIFORM && FIRST[s];
    give<9>(cI, s, ps[s], first, Ip);
    give<9>(cH, s, ps[s], first, Hp);
    give<9>(cM, s, ps[s], first, Mt);
    give<6>(cP, s, ps[s], first, fp);
  }

  // ---- the base: the branches' sums over the group
#pragma unroll
  for (int m = LPB; m < G; m <<= 1) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        cH[0][3 * r + c] += __shfl_xor_sync(0xffffffffu, cH[0][3 * r + c], m);
        if (c >= r) {
          cI[0][3 * r + c] += __shfl_xor_sync(0xffffffffu, cI[0][3 * r + c], m);
          cM[0][3 * r + c] += __shfl_xor_sync(0xffffffffu, cM[0][3 * r + c], m);
        }
      }
#pragma unroll
    for (int i = 0; i < 6; ++i) cP[0][i] += __shfl_xor_sync(0xffffffffu, cP[0][i], m);
  }
  const float* ci = cI[0];
  const float* ch = cH[0];
  const float* cm = cM[0];
  const float* cp = cP[0];
#endif
  // its spheres' sums over all lanes; every lane then holds the same 6x6
  // system and solves it
#pragma unroll
  for (int m = 1; m < G; m <<= 1)
#pragma unroll
    for (int i = 0; i < 6; ++i) wb[i] += __shfl_xor_sync(0xffffffffu, wb[i], m);

  float a0[6];
  {
    const float m0 = scr[SC_M0 * BLOCK];
    const float h0[3] = {scr[(SC_M0 + 1) * BLOCK], scr[(SC_M0 + 2) * BLOCK],
                         scr[(SC_M0 + 3) * BLOCK]};
    float I0[9];
    I0[0] = scr[(SC_M0 + 4) * BLOCK]; I0[1] = scr[(SC_M0 + 5) * BLOCK];
    I0[2] = scr[(SC_M0 + 6) * BLOCK]; I0[4] = scr[(SC_M0 + 7) * BLOCK];
    I0[5] = scr[(SC_M0 + 8) * BLOCK]; I0[8] = scr[(SC_M0 + 9) * BLOCK];
    symmetrize(I0);
    float Iv[6], pa[6], g_b[3], hxg[3], n_b[3], f_b[3], rhs[6];
    inertia_mul(m0, h0, I0, v0, Iv);
    crf(v0, Iv, pa);
    gravity_body(E0b, g_b);
    cross3(h0, g_b, hxg);
    mv3(E0b, wb, n_b);
    mv3(E0b, wb + 3, f_b);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rhs[i] = -(pa[i] - hxg[i] - n_b[i] + cp[i]);
      rhs[3 + i] = -(pa[3 + i] - m0 * g_b[i] - f_b[i] + cp[3 + i]);
    }
    float A11[9], A12[9], A22[9];
    A11[0] = I0[0] + ci[0]; A11[1] = I0[1] + ci[1]; A11[2] = I0[2] + ci[2];
    A11[4] = I0[4] + ci[4]; A11[5] = I0[5] + ci[5]; A11[8] = I0[8] + ci[8];
    symmetrize(A11);
    A12[0] = ch[0]; A12[1] = ch[1] - h0[2]; A12[2] = ch[2] + h0[1];
    A12[3] = ch[3] + h0[2]; A12[4] = ch[4]; A12[5] = ch[5] - h0[0];
    A12[6] = ch[6] - h0[1]; A12[7] = ch[7] + h0[0]; A12[8] = ch[8];
    A22[0] = cm[0] + m0; A22[1] = cm[1]; A22[2] = cm[2]; A22[4] = cm[4] + m0; A22[5] = cm[5];
    A22[8] = cm[8] + m0;
    symmetrize(A22);
    solve66(A11, A12, A22, rhs, a0);
  }

  // ---- outward: joint accelerations, then the joints' integration
  float acc[D][6];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    const int k = ROTK[s];
    float ap[6], ai[6];
    pick<6>(ap, a0, acc, s, ps[s]);
    const float jp[3] = {LC(JPOS, 3 * s), LC(JPOS, 3 * s + 1), LC(JPOS, 3 * s + 2)};
    xform_motion(k, rc[s], rs[s], Eup[s], jp, ap, ai);
#pragma unroll
    for (int i = 0; i < 6; ++i) ai[i] += cb[s][i];
    float Ua = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) Ua += Uw[s][i] * ai[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) Ua += Uv[s][i] * ai[3 + i];
    const float qdd = (u[s] - Ua) * inv_d[s];
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[s][i] = ai[i];
    if (k >= 0) {
      acc[s][k] += qdd;
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[s][i] += LC(AXIS, 3 * s + i) * qdd;
    }
    float vj = qd[s] + qdd * dt;
#if LGC_FL_IMPLICIT
    // implicit Coulomb stiction, before the velocity limit
    vj -= fminf(fmaxf(vj, -LC(DQD, s)), LC(DQD, s));
#endif
#if LGC_DOF_VEL_CLAMP
    vj = fminf(fmaxf(vj, -LC(VLIM, s)), LC(VLIM, s));
#endif
    qd[s] = vj;
    q[s] = q[s] + vj * dt;
  }

  // ---- semi-implicit Euler of the base, in the base frame
  float w2[3], u2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w2[i] = v0[i] + a0[i] * dt;
    u2[i] = v0[3 + i] + a0[3 + i] * dt;
  }
  mv3(R, u2, lin);
  mv3(R, w2, ang);
#pragma unroll
  for (int i = 0; i < 3; ++i) pos[i] = pos[i] + lin[i] * dt;

  float angle = sqrtf(w2[0] * w2[0] + w2[1] * w2[1] + w2[2] * w2[2]);
  angle = fmaxf(angle, 1e-9f);
  const float inv_angle = 1.0f / angle;
  const float half = 0.5f * angle * dt;
  float ch_, sh_;
  sincosf(half, &sh_, &ch_);
  const float dq[4] = {ch_, w2[0] * inv_angle * sh_, w2[1] * inv_angle * sh_,
                       w2[2] * inv_angle * sh_};
  const float qw = quat[0], qx = quat[1], qy = quat[2], qz = quat[3];
  float nq[4] = {
      qw * dq[0] - qx * dq[1] - qy * dq[2] - qz * dq[3],
      qw * dq[1] + qx * dq[0] + qy * dq[3] - qz * dq[2],
      qw * dq[2] - qx * dq[3] + qy * dq[0] + qz * dq[1],
      qw * dq[3] + qx * dq[2] - qy * dq[1] + qz * dq[0],
  };
  float qn = sqrtf(nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] + nq[3] * nq[3]);
  qn = 1.0f / fmaxf(qn, 1e-9f);
#pragma unroll
  for (int i = 0; i < 4; ++i) quat[i] = nq[i] * qn;
}

// ---------------------------------------------------------------------------
// The link states of the final state (reference link_states): one more
// outward pass, and each link-state entry of a lane's slot (or of the base)
// writes its link's world position base_pos + p0 + E0^T l and linear
// velocity E0^T (u + w x l), with l the link frame's origin in its body's
// frame.  The lane plan gives every link to exactly one lane that holds its
// body.  No shuffles: the lanes need not meet.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void link_state(int e, const float* E0, const float* p0, const float* v,
                                           const float* pos, const float* ftab, const int* itab,
                                           int lane, bool live, int n, int B,
                                           float* __restrict__ lpos_out,
                                           float* __restrict__ lvel_out) {
  LGC_PLAN_CONSTANTS
  const int l = itab[(LGC_P_ROW_LSLINK + e) * G + lane];
  if (!live || l < 0) return;
  const float lp[3] = {LC(LPOS, 3 * e), LC(LPOS, 3 * e + 1), LC(LPOS, 3 * e + 2)};
  float off[3], wxl[3], vel_b[3], vel_w[3];
  mtv3(E0, lp, off);
  cross3(v, lp, wxl);
#pragma unroll
  for (int k = 0; k < 3; ++k) vel_b[k] = v[3 + k] + wxl[k];
  mtv3(E0, vel_b, vel_w);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lpos_out[(3 * l + k) * B + n] = pos[k] + p0[k] + off[k];
    lvel_out[(3 * l + k) * B + n] = vel_w[k];
  }
}

__device__ __forceinline__ void link_states(const float* pos, const float* quat, const float* lin,
                                            const float* ang, const float* q, const float* qd,
                                            const float* ftab, const int* itab, int lane,
                                            bool live, int n, int B,
                                            float* __restrict__ lpos_out,
                                            float* __restrict__ lvel_out) {
  LGC_PLAN_CONSTANTS
  float R[9], E0b[9], v0[6];
  base_frame(quat, lin, ang, R, E0b, v0);
  int ps[D];
  parent_slots(itab, lane, ps);
  float E0[D][9], p0[D][3], Eup[D][9], rc[D], rs[D], v[D][6];
#pragma unroll
  for (int s = 0; s < D; ++s) {
    slot_kinematics(s, ps[s], E0b, v0, q, qd, ftab, lane, E0, p0, Eup, rc, rs, v);
#pragma unroll
    for (int i = 0; i < LGC_P_MAX_NLS; ++i)
      if (i < NLS[s])
        link_state(LS0[s] + i, E0[s], p0[s], v[s], pos, ftab, itab, lane, live, n, B, lpos_out,
                   lvel_out);
  }
  const float zero3[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < LGC_P_NLS_BASE; ++i)
    link_state(LGC_P_LS0_BASE + i, E0b, zero3, v0, pos, ftab, itab, lane, live, n, B, lpos_out,
               lvel_out);
}

// ---------------------------------------------------------------------------
// The kernel: G lanes per env, (C, B) fp32 rows in and out; for K3 also each
// env's (K, K) window (batch-leading) and its offsets xoff, yoff (B,); out
// also the link states (3 nl, B)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
fused_control_step_kernel(const float* __restrict__ pos_in, const float* __restrict__ quat_in,
                          const float* __restrict__ lin_in, const float* __restrict__ ang_in,
                          const float* __restrict__ q_in, const float* __restrict__ qd_in,
                          const float* __restrict__ act_in, const float* __restrict__ fric_in,
                          const float* __restrict__ am_in, const float* __restrict__ co_in,
                          const float* __restrict__ kp_in, const float* __restrict__ kd_in,
                          const float* __restrict__ patch_in, const float* __restrict__ xoff_in,
                          const float* __restrict__ yoff_in, float* __restrict__ pos_out,
                          float* __restrict__ quat_out, float* __restrict__ lin_out,
                          float* __restrict__ ang_out, float* __restrict__ q_out,
                          float* __restrict__ qd_out, float* __restrict__ lf_out,
                          float* __restrict__ tau_out, float* __restrict__ lpos_out,
                          float* __restrict__ lvel_out, int B) {
  LGC_PLAN_CONSTANTS
  extern __shared__ __align__(16) float smem[];
  float* ftab = smem;                                       // lane table [row][lane]
  int* itab = reinterpret_cast<int*>(ftab + FTAB_N);        // lane table of indices
  float* scr_all = reinterpret_cast<float*>(itab + ITAB_N);  // scratch [slot][thread]
  float* lfbuf = scr_all + NSCR * BLOCK;                    // link forces [env][3 nl]

  const int tid = threadIdx.x;
  const int lane = tid % G, grp = tid / G;
  const int env = blockIdx.x * EPB + grp;
  const bool live = env < B;        // an env beyond B computes, and stores nothing
  const int n = live ? env : B - 1;
  float* scr = scr_all + tid;

  for (int i = tid; i < FTAB_N; i += BLOCK) ftab[i] = FTAB_INIT[i];
  for (int i = tid; i < ITAB_N; i += BLOCK) itab[i] = ITAB_INIT[i];
  for (int i = tid; i < LFBUF_N; i += BLOCK) lfbuf[i] = 0.f;
  __syncthreads();

  float pos[3], quat[4], lin[3], ang[3], q[D], qd[D];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos[k] = pos_in[k * B + n];
    lin[k] = lin_in[k * B + n];
    ang[k] = ang_in[k * B + n];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) quat[k] = quat_in[k * B + n];
#pragma unroll
  for (int s = 0; s < D; ++s) {   // a masked slot reads zeros
    const int j = itab[(LGC_P_ROW_JLOAD + s) * G + lane];
    const bool has = j >= 0;
    const int at = (has ? j : 0) * B + n;
    q[s] = has ? q_in[at] : 0.f;
    qd[s] = has ? qd_in[at] : 0.f;
    scr[(SC_ACT + s) * BLOCK] = has ? act_in[at] : 0.f;
#if !LGC_CONTROL_T
    scr[(SC_KP + s) * BLOCK] = has ? kp_in[at] * LC(PG, s) : 0.f;
    scr[(SC_KD + s) * BLOCK] = has ? kd_in[at] * LC(DG, s) : 0.f;
#endif
  }
  const float mu = 0.5f * (fric_in[n] + LGC_TERRAIN_FRICTION);

  // randomized base inertia (reference _body_inertias_components)
  {
    constexpr float MASS0 = LGC_MASS0;
    constexpr float COM0[3] = LGC_COM0;
    constexpr float ICOM0[9] = LGC_ICOM0;
    const float m0 = MASS0 + am_in[n];
    float c[3];
    scr[SC_M0 * BLOCK] = m0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = COM0[k] + co_in[k * B + n];
      scr[(SC_M0 + 1 + k) * BLOCK] = m0 * c[k];
    }
    const float cx[9] = {0.f, -c[2], c[1], c[2], 0.f, -c[0], -c[1], c[0], 0.f};
    int at = SC_M0 + 4;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = r; s < 3; ++s) {
        const float cc = cx[3 * r] * cx[3 * s] + cx[3 * r + 1] * cx[3 * s + 1] +
                         cx[3 * r + 2] * cx[3 * s + 2];
        scr[at * BLOCK] = ICOM0[3 * r + s] + m0 * cc;
        ++at;
      }
  }

#if LGC_HF_K
  const float xoff = xoff_in[n], yoff = yoff_in[n];
  const float* win = patch_in + static_cast<size_t>(n) * (LGC_HF_K * LGC_HF_K);
#else
  const float* win = nullptr;
  const float xoff = 0.f, yoff = 0.f;
  (void)patch_in; (void)xoff_in; (void)yoff_in;
#endif

  float tau[D];
#pragma unroll 1
  for (int tick = 0; tick < LGC_DECIMATION; ++tick) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
#if LGC_CONTROL_T
      const float t = scr[(SC_ACT + s) * BLOCK] * LGC_ACTION_SCALE;
#else
      const float t = scr[(SC_KP + s) * BLOCK] *
                          (scr[(SC_ACT + s) * BLOCK] * LGC_ACTION_SCALE + LC(DPOS, s) - q[s]) -
                      scr[(SC_KD + s) * BLOCK] * qd[s];
#endif
      tau[s] = fminf(fmaxf(t, -LC(TLIM, s)), LC(TLIM, s));
    }
    // link forces: the mean over the substeps of the last tick only
    const bool last_tick = tick == LGC_DECIMATION - 1;
    if (last_tick) {
#pragma unroll
      for (int i = 0; i < 3 * NENT; ++i) scr[(SC_LF + i) * BLOCK] = 0.f;
    }
#pragma unroll 1
    for (int s = 0; s < LGC_SUBSTEPS; ++s)
      substep(pos, quat, lin, ang, q, qd, tau, mu, ftab, itab, lane, scr, win, xoff, yoff, s == 0,
              last_tick);
  }

  // ---- stores: the base by the group's first lane, each dof by its lane
  if (live && lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pos_out[k * B + n] = pos[k];
      lin_out[k * B + n] = lin[k];
      ang_out[k * B + n] = ang[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) quat_out[k * B + n] = quat[k];
  }
#pragma unroll
  for (int s = 0; s < D; ++s) {
    const int j = itab[(LGC_P_ROW_JSTORE + s) * G + lane];
    if (live && j >= 0) {
      q_out[j * B + n] = q[s];
      qd_out[j * B + n] = qd[s];
      tau_out[j * B + n] = tau[s];
    }
  }
  // link forces: the lanes add their entries' sums to the env's links in lane
  // order, then the group writes the links out
  float* lf_env = lfbuf + grp * (3 * NL);
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    if (lane == g) {
#pragma unroll
      for (int e = 0; e < NENT; ++e) {
        const int l = itab[(LGC_P_ROW_LINK + e) * G + lane];
        if (l >= 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) lf_env[3 * l + k] += scr[(SC_LF + 3 * e + k) * BLOCK];
        }
      }
    }
    __syncwarp();
  }
  constexpr float inv_ns = 1.0f / LGC_SUBSTEPS;
  if (live)
    for (int i = lane; i < 3 * NL; i += G) lf_out[i * B + n] = lf_env[i] * inv_ns;

  link_states(pos, quat, lin, ang, q, qd, ftab, itab, lane, live, n, B, lpos_out, lvel_out);
}

static cudaError_t allow_shared_memory() {
  static cudaError_t status = cudaFuncSetAttribute(
      fused_control_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  return status;
}

extern "C" int lgc_fused_control_step(const float* pos, const float* quat, const float* lin,
                                      const float* ang, const float* q, const float* qd,
                                      const float* act, const float* fric, const float* am,
                                      const float* co, const float* kp, const float* kd,
                                      const float* patch, const float* xoff, const float* yoff,
                                      float* opos, float* oquat, float* olin, float* oang,
                                      float* oq, float* oqd, float* olf, float* otau,
                                      float* olpos, float* olvel, int B, void* stream) {
  if (B <= 0) return 0;
  if (olpos == nullptr || olvel == nullptr) return cudaErrorInvalidValue;
#if LGC_HF_K
  if (patch == nullptr || xoff == nullptr || yoff == nullptr) return cudaErrorInvalidValue;
#endif
  const cudaError_t status = allow_shared_memory();
  if (status != cudaSuccess) return static_cast<int>(status);
  const int grid = (B + EPB - 1) / EPB;
  fused_control_step_kernel<<<grid, BLOCK, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      pos, quat, lin, ang, q, qd, act, fric, am, co, kp, kd, patch, xoff, yoff, opos, oquat, olin,
      oang, oq, oqd, olf, otau, olpos, olvel, B);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape for B envs: out = {G, block, grid, static shared bytes,
// dynamic shared bytes, resident blocks per SM, registers per thread,
// local-memory bytes per thread, lanes per branch}
extern "C" int lgc_fused_launch_info(int B, int* out) {
  cudaError_t status = allow_shared_memory();
  if (status != cudaSuccess) return static_cast<int>(status);
  cudaFuncAttributes attr;
  status = cudaFuncGetAttributes(&attr, fused_control_step_kernel);
  if (status != cudaSuccess) return static_cast<int>(status);
  int resident = 0;
  status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fused_control_step_kernel,
                                                         BLOCK, SMEM_BYTES);
  if (status != cudaSuccess) return static_cast<int>(status);
  out[0] = G;
  out[1] = BLOCK;
  out[2] = (B + EPB - 1) / EPB;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = static_cast<int>(SMEM_BYTES);
  out[5] = resident;
  out[6] = attr.numRegs;
  out[7] = static_cast<int>(attr.localSizeBytes);
  out[8] = LPB;
  return 0;
}

extern "C" const char* lgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
