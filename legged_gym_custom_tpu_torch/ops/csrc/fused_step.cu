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
//           to FL_DQD[j] = frictionloss * dt_sub / m_eff of velocity toward
//           zero, so a joint inside the dead zone ends at exactly 0.  The
//           12 clamps are compile-time immediates (the float32 values the
//           plain version uses), so K2 moves the same bytes as K1 / K3.
//
// One thread per env runs a whole 50 Hz control step: decimation ticks of
// clipped PD torques, each followed by `substeps` semi-implicit Euler
// substeps of forward kinematics, plane penalty contact with regularized
// Coulomb friction, joint-limit / viscous / tanh-frictionloss torques and the
// articulated-body algorithm with armature and a 6x6 base solve by 3x3 Schur
// blocks.  The state stays in registers / local memory across all substeps;
// device memory sees only (C, B) fp32 rows in and out, each component row
// read and written coalesced across the threads of a warp.
//
// Bound: by operations, not bytes.  Per env the step moves ~180 floats but
// does some 10^5 fp32 operations (16 substeps of a 13-body ABA).  The work is
// a long serial chain per env (the tree walked outward, inward, outward), so
// this first design gives each env its own thread and lets the baked-in
// model constants fold at compile time.  The 13 articulated inertias (6x6)
// exceed the register file and spill to local memory; a warp-per-env layout
// with shared-memory IA is the next step.
//
// K3: the TPU kernel keeps each env's window in VMEM and samples it by a
// one-hot K-row contraction, because a TPU has no lane-parallel gather.  Here
// a sample is four direct reads of the window: the window is batch-leading
// (B, K, K), so an env's 2304 B (K = 24) are contiguous, and the clamp of the
// grid coordinate to K - 1.001 keeps the x0 + 1 / y0 + 1 taps inside it.  The
// surface under every sphere is sampled at the first substep of each
// decimation tick and held in registers through the tick's substeps
// (terrain_tick_sample).  Per env K3 moves K1's 184 floats plus K*K + 2; its
// bound stays set by operations, the terrain adding about 1 % to K1's count.
//
// The robot and sim constants come from a generated header (ops/fused_step.py
// ::spec_header, passed with -include); every loop over bodies, geoms and dofs
// is unrolled so each constant index is known at compile time.

#include <cuda_runtime.h>
#include <math.h>

#ifndef LGC_NB
#error "compile with -include <spec header> written by ops/fused_step.py"
#endif

constexpr int NB = LGC_NB;
constexpr int NDOF = NB - 1;
constexpr int NG = LGC_NG;
constexpr int NL = LGC_NL;
constexpr int BLOCK = 32;

// The model constants, declared in every device function that reads them.
#define LGC_SPEC_CONSTANTS                                        \
  constexpr int PARENT[NB] = LGC_PARENT;                          \
  constexpr float JROT[NB * 9] = LGC_JOINT_ROT;                   \
  constexpr float JPOS[NB * 3] = LGC_JOINT_POS;                   \
  constexpr float JAXIS[NB * 3] = LGC_JOINT_AXIS;                 \
  constexpr float MASS[NB] = LGC_MASS;                            \
  constexpr float COM[NB * 3] = LGC_COM;                          \
  constexpr float ICOM[NB * 9] = LGC_INERTIA_COM;                 \
  constexpr int GBODY[NG] = LGC_GEOM_BODY;                        \
  constexpr float GPOS[NG * 3] = LGC_GEOM_POS;                    \
  constexpr float GRAD[NG] = LGC_GEOM_RADIUS;                     \
  constexpr int GLINK[NG] = LGC_GEOM_LINK;                        \
  constexpr float GRAV[3] = LGC_GRAVITY;                          \
  constexpr float JD_DAMP[NDOF] = LGC_JD_DAMPING;                 \
  constexpr float JD_ARM[NDOF] = LGC_JD_ARMATURE;                 \
  constexpr float JD_FL[NDOF] = LGC_JD_FRICTIONLOSS;              \
  constexpr float P_GAINS[NDOF] = LGC_P_GAINS;                    \
  constexpr float D_GAINS[NDOF] = LGC_D_GAINS;                    \
  constexpr float DEFAULT_POS[NDOF] = LGC_DEFAULT_DOF_POS;        \
  constexpr float TLIM[NDOF] = LGC_TORQUE_LIMITS;                 \
  constexpr float DOF_LO[NDOF] = LGC_DOF_LO;                      \
  constexpr float DOF_HI[NDOF] = LGC_DOF_HI;                      \
  constexpr float DOF_VLIM[NDOF] = LGC_DOF_VLIM;                  \
  constexpr float FL_DQD[NDOF] = LGC_FL_DQD;                      \
  (void)PARENT; (void)JROT; (void)JPOS; (void)JAXIS; (void)MASS;  \
  (void)COM; (void)ICOM; (void)GBODY; (void)GPOS; (void)GRAD;     \
  (void)GLINK; (void)GRAV; (void)JD_DAMP; (void)JD_ARM;           \
  (void)JD_FL; (void)P_GAINS; (void)D_GAINS; (void)DEFAULT_POS;   \
  (void)TLIM; (void)DOF_LO; (void)DOF_HI; (void)DOF_VLIM;         \
  (void)FL_DQD;

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

// motion transform X = (E, p): [E w; E (v - p x w)]
__device__ __forceinline__ void xform_motion(const float* E, const float* p, const float* m,
                                             float* o) {
  float pxw[3], t[3];
  cross3(p, m, pxw);
  t[0] = m[3] - pxw[0];
  t[1] = m[4] - pxw[1];
  t[2] = m[5] - pxw[2];
  mv3(E, m, o);
  mv3(E, t, o + 3);
}

// inverse force transform: [E^T n + p x (E^T f); E^T f]
__device__ __forceinline__ void inv_xform_force(const float* E, const float* p, const float* f,
                                                float* o) {
  float n[3], ff[3], pxf[3];
  mtv3(E, f, n);
  mtv3(E, f + 3, ff);
  cross3(p, ff, pxf);
  o[0] = n[0] + pxf[0];
  o[1] = n[1] + pxf[1];
  o[2] = n[2] + pxf[2];
  o[3] = ff[0];
  o[4] = ff[1];
  o[5] = ff[2];
}

// spatial motion cross product v x m
__device__ __forceinline__ void crm(const float* v, const float* m, float* o) {
  float a[3], b[3];
  cross3(v, m, o);
  cross3(v, m + 3, a);
  cross3(v + 3, m, b);
  o[3] = a[0] + b[0];
  o[4] = a[1] + b[1];
  o[5] = a[2] + b[2];
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

// row-major 6x6 [[I, hx], [-hx, m 1]]
__device__ __forceinline__ void inertia_mat66(float m, const float* h, const float* I, float* M) {
  const float hx[9] = {0.f, -h[2], h[1], h[2], 0.f, -h[0], -h[1], h[0], 0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      M[6 * i + j] = I[3 * i + j];
      M[6 * i + 3 + j] = hx[3 * i + j];
      M[6 * (3 + i) + j] = -hx[3 * i + j];
      M[6 * (3 + i) + 3 + j] = (i == j) ? m : 0.f;
    }
  }
}

__device__ __forceinline__ void inv3(const float* M, float* o) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5], g = M[6], h = M[7],
              i = M[8];
  const float A = e * i - f * h, B = c * h - b * i, C = b * f - c * e;
  const float D = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
  const float G = d * h - e * g, H = b * g - a * h, I = a * e - b * d;
  const float inv_det = 1.0f / (a * A + b * D + c * G);
  o[0] = A * inv_det; o[1] = B * inv_det; o[2] = C * inv_det;
  o[3] = D * inv_det; o[4] = E * inv_det; o[5] = F * inv_det;
  o[6] = G * inv_det; o[7] = H * inv_det; o[8] = I * inv_det;
}

// SPD 6x6 solve A x = b via 3x3 Schur blocks (reference soa.solve66)
__device__ __forceinline__ void solve66(const float* A, const float* b, float* x) {
  float A11[9], A12[9], A21[9], A22[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A11[3 * i + j] = A[6 * i + j];
      A12[3 * i + j] = A[6 * i + 3 + j];
      A21[3 * i + j] = A[6 * (3 + i) + j];
      A22[3 * i + j] = A[6 * (3 + i) + 3 + j];
    }
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
// Per-body spatial inertia about the body origin; body 0 carries the per-env
// added mass and com offset, the others are compile-time constants.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void body_inertia(int i, float m0, const float* h0, const float* I0,
                                             float& m, float* h, float* I) {
  LGC_SPEC_CONSTANTS
  if (i == 0) {
    m = m0;
#pragma unroll
    for (int k = 0; k < 3; ++k) h[k] = h0[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) I[k] = I0[k];
    return;
  }
  const float mi = MASS[i];
  const float* c = &COM[3 * i];
  const float cx[9] = {0.f, -c[2], c[1], c[2], 0.f, -c[0], -c[1], c[0], 0.f};
  m = mi;
#pragma unroll
  for (int k = 0; k < 3; ++k) h[k] = mi * c[k];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float cc = cx[3 * r] * cx[3 * s] + cx[3 * r + 1] * cx[3 * s + 1] +
                       cx[3 * r + 2] * cx[3 * s + 2];
      I[3 * r + s] = ICOM[9 * i + 3 * r + s] + mi * cc;
    }
}

// ---------------------------------------------------------------------------
// One semi-implicit Euler substep (reference _substep_components).  K3 reads
// the tick's frozen surface from `surf` (4 floats per geom) and, when
// `sample_now` (the tick's first substep), samples it there first.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void substep(float* pos, float* quat, float* lin, float* ang, float* q,
                                        float* qd, const float* tau, float mu, float m0,
                                        const float* h0, const float* I0, float* lf_sum,
                                        const float* __restrict__ patch, float xoff, float yoff,
                                        float* surf, bool sample_now) {
  LGC_SPEC_CONSTANTS
  constexpr float dt = LGC_DT_SUB;

  // base rotation (world <- base) and spatial velocity in base coords
  float R[9];
  {
    const float w = quat[0], x = quat[1], y = quat[2], z = quat[3];
    R[0] = 1.f - 2.f * (y * y + z * z); R[1] = 2.f * (x * y - w * z); R[2] = 2.f * (x * z + w * y);
    R[3] = 2.f * (x * y + w * z); R[4] = 1.f - 2.f * (x * x + z * z); R[5] = 2.f * (y * z - w * x);
    R[6] = 2.f * (x * z - w * y); R[7] = 2.f * (y * z + w * x); R[8] = 1.f - 2.f * (x * x + y * y);
  }

  // ---- forward kinematics
  float E0[NB][9], Eup[NB][9], p0[NB][3], v[NB][6];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) E0[0][3 * r + c] = R[3 * c + r];
  p0[0][0] = p0[0][1] = p0[0][2] = 0.f;
  mtv3(R, ang, v[0]);
  mtv3(R, lin, v[0] + 3);
#pragma unroll
  for (int i = 1; i < NB; ++i) {
    const int p = PARENT[i];
    const float* a = &JAXIS[3 * i];
    const float cq = cosf(q[i - 1]), sq = sinf(q[i - 1]);
    const float ax[9] = {0.f, -a[2], a[1], a[2], 0.f, -a[0], -a[1], a[0], 0.f};
    float Ej[9];  // E_j = R(axis, q)^T
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        Ej[3 * c + r] = (r == c ? cq : 0.f) + sq * ax[3 * r + c] + (1.f - cq) * (a[r] * a[c]);
    mm3(Ej, &JROT[9 * i], Eup[i]);
    mm3(Eup[i], E0[p], E0[i]);
    float t[3];
    mtv3(E0[p], &JPOS[3 * i], t);
#pragma unroll
    for (int k = 0; k < 3; ++k) p0[i][k] = p0[p][k] + t[k];
    xform_motion(Eup[i], &JPOS[3 * i], v[p], v[i]);
#pragma unroll
    for (int k = 0; k < 3; ++k) v[i][k] += a[k] * qd[i - 1];
  }

  // ---- penalty contact (plane, or the tick's heightfield surface)
  float wrench[NB][6];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int k = 0; k < 6; ++k) wrench[i][k] = 0.f;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int b = GBODY[g];
    const float* gp = &GPOS[3 * g];
    float off[3], wxg[3], vel_b[3], vel_w[3];
    mtv3(E0[b], gp, off);
    const float cz = pos[2] + p0[b][2] + off[2];
    cross3(v[b], gp, wxg);
    vel_b[0] = v[b][3] + wxg[0];
    vel_b[1] = v[b][4] + wxg[1];
    vel_b[2] = v[b][5] + wxg[2];
    mtv3(E0[b], vel_b, vel_w);
#if LGC_HF_K
    float* sg = &surf[4 * g];
    if (sample_now) tile_surface(patch, xoff, yoff, pos[0] + p0[b][0] + off[0],
                                 pos[1] + p0[b][1] + off[1], sg);
    const float h = sg[0], nx = sg[1], ny = sg[2], nz = sg[3];
    const float depth = GRAD[g] - nz * (cz - h);
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
    (void)patch; (void)xoff; (void)yoff; (void)surf; (void)sample_now;
    const float depth = GRAD[g] - cz;
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
      wrench[b][k] += torque[k];
      wrench[b][3 + k] += force[k];
      lf_sum[3 * GLINK[g] + k] += force[k];
    }
  }

  // ---- joint-limit torque + passive joint dynamics
  float tau_total[NDOF];
#pragma unroll
  for (int j = 0; j < NDOF; ++j) {
    const float below = fminf(q[j] - DOF_LO[j], 0.f);
    const float above = fmaxf(q[j] - DOF_HI[j], 0.f);
    const bool viol = (below < 0.f) || (above > 0.f);
    float t = tau[j] + (-LGC_JL_STIFFNESS * (below + above) - (viol ? LGC_JL_DAMPING * qd[j] : 0.f));
    if (JD_DAMP[j] != 0.f) t = t - JD_DAMP[j] * qd[j];
#if !LGC_FL_IMPLICIT
    // tanh surrogate; implicit stiction clamps the velocity after the
    // integration instead
    if (JD_FL[j] != 0.f) t = t - JD_FL[j] * tanhf(qd[j] * LGC_INV_FL_EPS);
#endif
    tau_total[j] = t;
  }

  // ---- articulated-body algorithm
  float cb[NB][6];  // velocity-product accelerations c_i = v_i x vJ_i
#pragma unroll
  for (int i = 1; i < NB; ++i) {
    const float* a = &JAXIS[3 * i];
    const float vJ[6] = {a[0] * qd[i - 1], a[1] * qd[i - 1], a[2] * qd[i - 1], 0.f, 0.f, 0.f};
    crm(v[i], vJ, cb[i]);
  }

  // children's contributions, accumulated into the parent (zero until then)
  float IAc[NB][36], pAc[NB][6];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int k = 0; k < 36; ++k) IAc[i][k] = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) pAc[i][k] = 0.f;
  }
  float U[NB][6], d[NB], u[NB];
  float IA0[36], pA0[6];
#pragma unroll
  for (int i = NB - 1; i >= 0; --i) {
    // this body's own articulated inertia and bias force, plus its children's
    float m, h[3], I[9], IA[36], pA[6];
    body_inertia(i, m0, h0, I0, m, h, I);
    inertia_mat66(m, h, I, IA);
#pragma unroll
    for (int k = 0; k < 36; ++k) IA[k] += IAc[i][k];
    {
      float Iv[6], pa[6], g_b[3], hxg[3], n_b[3], f_b[3];
      inertia_mul(m, h, I, v[i], Iv);
      crf(v[i], Iv, pa);
      mv3(E0[i], GRAV, g_b);
      cross3(h, g_b, hxg);
      mv3(E0[i], wrench[i], n_b);
      mv3(E0[i], wrench[i] + 3, f_b);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pA[k] = pa[k] - hxg[k] - n_b[k] + pAc[i][k];
        pA[3 + k] = pa[3 + k] - m * g_b[k] - f_b[k] + pAc[i][3 + k];
      }
    }
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < 36; ++k) IA0[k] = IA[k];
#pragma unroll
      for (int k = 0; k < 6; ++k) pA0[k] = pA[k];
      break;
    }
    const int p = PARENT[i];
    const float* a = &JAXIS[3 * i];
    // U = IA S with S = [axis; 0]
#pragma unroll
    for (int r = 0; r < 6; ++r) U[i][r] = IA[6 * r] * a[0] + IA[6 * r + 1] * a[1] + IA[6 * r + 2] * a[2];
    d[i] = (a[0] * U[i][0] + a[1] * U[i][1] + a[2] * U[i][2]) + JD_ARM[i - 1];
    u[i] = tau_total[i - 1] - (a[0] * pA[0] + a[1] * pA[1] + a[2] * pA[2]);
    const float inv_d = 1.0f / d[i];
    float Ia[36];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) Ia[6 * r + c] = IA[6 * r + c] - U[i][r] * U[i][c] * inv_d;
    float pa2[6];
    const float uid = u[i] * inv_d;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) s += Ia[6 * r + c] * cb[i][c];
      pa2[r] = pA[r] + s + U[i][r] * uid;
    }
    // X = [[E, 0], [-E hat(p), E]]; parent gets X^T Ia X and X^T pa2
    const float* E = Eup[i];
    const float* jp = &JPOS[3 * i];
    const float px[9] = {0.f, -jp[2], jp[1], jp[2], 0.f, -jp[0], -jp[1], jp[0], 0.f};
    float Epx[9];
    mm3(E, px, Epx);
    float X[36];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        X[6 * r + c] = E[3 * r + c];
        X[6 * r + 3 + c] = 0.f;
        X[6 * (3 + r) + c] = -Epx[3 * r + c];
        X[6 * (3 + r) + 3 + c] = E[3 * r + c];
      }
    float IaX[36];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 6; ++t) s += Ia[6 * r + t] * X[6 * t + c];
        IaX[6 * r + c] = s;
      }
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < 6; ++t) s += X[6 * t + r] * IaX[6 * t + c];
        IAc[p][6 * r + c] += s;
      }
    float fp[6];
    inv_xform_force(E, jp, pa2, fp);
#pragma unroll
    for (int k = 0; k < 6; ++k) pAc[p][k] += fp[k];
  }

  float a0[6], npA0[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) npA0[k] = -pA0[k];
  solve66(IA0, npA0, a0);

  float acc[NB][6], qdd[NDOF];
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[0][k] = a0[k];
#pragma unroll
  for (int i = 1; i < NB; ++i) {
    const int p = PARENT[i];
    const float* a = &JAXIS[3 * i];
    float ai[6];
    xform_motion(Eup[i], &JPOS[3 * i], acc[p], ai);
#pragma unroll
    for (int k = 0; k < 6; ++k) ai[k] += cb[i][k];
    float Ua = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) Ua += U[i][k] * ai[k];
    qdd[i - 1] = (u[i] - Ua) * (1.0f / d[i]);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[i][k] = ai[k] + a[k] * qdd[i - 1];
#pragma unroll
    for (int k = 3; k < 6; ++k) acc[i][k] = ai[k];
  }

  // ---- semi-implicit Euler in the base frame
  float w2[3], u2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w2[k] = v[0][k] + a0[k] * dt;
    u2[k] = v[0][3 + k] + a0[3 + k] * dt;
  }
  mv3(R, u2, lin);
  mv3(R, w2, ang);
#pragma unroll
  for (int k = 0; k < 3; ++k) pos[k] = pos[k] + lin[k] * dt;

  float angle = sqrtf(w2[0] * w2[0] + w2[1] * w2[1] + w2[2] * w2[2]);
  angle = fmaxf(angle, 1e-9f);
  const float inv_angle = 1.0f / angle;
  const float half = 0.5f * angle * dt;
  const float ch = cosf(half), sh = sinf(half);
  const float dq[4] = {ch, w2[0] * inv_angle * sh, w2[1] * inv_angle * sh, w2[2] * inv_angle * sh};
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
  for (int k = 0; k < 4; ++k) quat[k] = nq[k] * qn;

#pragma unroll
  for (int j = 0; j < NDOF; ++j) {
    float vj = qd[j] + qdd[j] * dt;
#if LGC_FL_IMPLICIT
    vj -= fminf(fmaxf(vj, -FL_DQD[j]), FL_DQD[j]);
#endif
#if LGC_DOF_VEL_CLAMP
    vj = fminf(fmaxf(vj, -DOF_VLIM[j]), DOF_VLIM[j]);
#endif
    qd[j] = vj;
    q[j] = q[j] + vj * dt;
  }
}

// ---------------------------------------------------------------------------
// The kernel: one thread per env, (C, B) fp32 rows in and out; for K3 also
// each env's (K, K) window (batch-leading) and its offsets xoff, yoff (B,)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
fused_control_step_kernel(const float* __restrict__ pos_in, const float* __restrict__ quat_in,
                          const float* __restrict__ lin_in, const float* __restrict__ ang_in,
                          const float* __restrict__ q_in, const float* __restrict__ qd_in,
                          const float* __restrict__ act_in, const float* __restrict__ fric_in,
                          const float* __restrict__ am_in, const float* __restrict__ co_in,
                          const float* __restrict__ kp_in, const float* __restrict__ kd_in,
                          const float* __restrict__ patch_in, const float* __restrict__ xoff_in,
                          const float* __restrict__ yoff_in, float* __restrict__ pos_out, float* __restrict__ quat_out,
                          float* __restrict__ lin_out, float* __restrict__ ang_out,
                          float* __restrict__ q_out, float* __restrict__ qd_out,
                          float* __restrict__ lf_out, float* __restrict__ tau_out, int B) {
  LGC_SPEC_CONSTANTS
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= B) return;

  float pos[3], quat[4], lin[3], ang[3], q[NDOF], qd[NDOF], act[NDOF], kp[NDOF], kd[NDOF];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos[k] = pos_in[k * B + n];
    lin[k] = lin_in[k * B + n];
    ang[k] = ang_in[k * B + n];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) quat[k] = quat_in[k * B + n];
#pragma unroll
  for (int j = 0; j < NDOF; ++j) {
    q[j] = q_in[j * B + n];
    qd[j] = qd_in[j * B + n];
    act[j] = act_in[j * B + n];
    kp[j] = kp_in[j * B + n] * P_GAINS[j];
    kd[j] = kd_in[j * B + n] * D_GAINS[j];
  }
#if LGC_CONTROL_T
  (void)kp; (void)kd;
#endif
  const float mu = 0.5f * (fric_in[n] + LGC_TERRAIN_FRICTION);

  // randomized base inertia (reference _body_inertias_components)
  float m0, h0[3], I0[9];
  {
    m0 = MASS[0] + am_in[n];
    float c[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = COM[k] + co_in[k * B + n];
      h0[k] = m0 * c[k];
    }
    const float cx[9] = {0.f, -c[2], c[1], c[2], 0.f, -c[0], -c[1], c[0], 0.f};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float cc = cx[3 * r] * cx[3 * s] + cx[3 * r + 1] * cx[3 * s + 1] +
                         cx[3 * r + 2] * cx[3 * s + 2];
        I0[3 * r + s] = ICOM[3 * r + s] + m0 * cc;
      }
  }

#if LGC_HF_K
  const float* patch = patch_in + static_cast<size_t>(n) * (LGC_HF_K * LGC_HF_K);
  const float xoff = xoff_in[n], yoff = yoff_in[n];
  float surf[4 * NG];  // the tick's frozen (h, nx, ny, nz) per geom
#else
  const float* patch = nullptr;
  const float xoff = 0.f, yoff = 0.f;
  float* surf = nullptr;
  (void)patch_in; (void)xoff_in; (void)yoff_in;
#endif

  float tau[NDOF], lf_sum[3 * NL];
#pragma unroll 1
  for (int tick = 0; tick < LGC_DECIMATION; ++tick) {
#pragma unroll
    for (int j = 0; j < NDOF; ++j) {
#if LGC_CONTROL_T
      const float t = act[j] * LGC_ACTION_SCALE;
#else
      const float t = kp[j] * (act[j] * LGC_ACTION_SCALE + DEFAULT_POS[j] - q[j]) - kd[j] * qd[j];
#endif
      tau[j] = fminf(fmaxf(t, -TLIM[j]), TLIM[j]);
    }
#pragma unroll
    for (int k = 0; k < 3 * NL; ++k) lf_sum[k] = 0.f;
#pragma unroll 1
    for (int s = 0; s < LGC_SUBSTEPS; ++s) {
      substep(pos, quat, lin, ang, q, qd, tau, mu, m0, h0, I0, lf_sum, patch, xoff, yoff, surf,
              s == 0);
    }
  }

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pos_out[k * B + n] = pos[k];
    lin_out[k * B + n] = lin[k];
    ang_out[k * B + n] = ang[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) quat_out[k * B + n] = quat[k];
#pragma unroll
  for (int j = 0; j < NDOF; ++j) {
    q_out[j * B + n] = q[j];
    qd_out[j * B + n] = qd[j];
    tau_out[j * B + n] = tau[j];
  }
  // mean over the substeps of the last tick
  constexpr float inv_ns = 1.0f / LGC_SUBSTEPS;
#pragma unroll
  for (int k = 0; k < 3 * NL; ++k) lf_out[k * B + n] = lf_sum[k] * inv_ns;
}

extern "C" int lgc_fused_control_step(const float* pos, const float* quat, const float* lin,
                                      const float* ang, const float* q, const float* qd,
                                      const float* act, const float* fric, const float* am,
                                      const float* co, const float* kp, const float* kd,
                                      const float* patch, const float* xoff, const float* yoff,
                                      float* opos, float* oquat, float* olin, float* oang,
                                      float* oq, float* oqd, float* olf, float* otau, int B,
                                      void* stream) {
  if (B <= 0) return 0;
#if LGC_HF_K
  if (patch == nullptr || xoff == nullptr || yoff == nullptr) return cudaErrorInvalidValue;
#endif
  const int grid = (B + BLOCK - 1) / BLOCK;
  fused_control_step_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, quat, lin, ang, q, qd, act, fric, am, co, kp, kd, patch, xoff, yoff, opos, oquat, olin,
      oang, oq, oqd, olf, otau, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lgc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
