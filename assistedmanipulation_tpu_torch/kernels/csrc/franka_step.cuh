// The Franka-Ridgeback rollout step shared by the port's CUDA kernels
// (sample_rollout.cuh, rollout.cu): the compiled-in topology, the by-value
// model and objective constants (Params), and one rollout step for one
// rollout in parts: forward_kinematics, step_costs (the scenario-free cost
// terms), add_trajectory_cost, manipulability_cost and step_dynamics (CRBA
// mass matrix, implicit PD + Coulomb friction diagonal, 12x12 Cholesky solve
// and semi-implicit Euler). In that order they are the per-thread form of
// kernels/lane_rollout.py::step_cost_and_dynamics; the parts let a kernel
// that scores several forecast scenarios run the trajectory term per
// scenario, and one that splits a step between two warps run the kinematics
// in both and the rest in one each.
//
// Everything sits in an anonymous namespace: each kernel source that
// includes this header gets its own copy, and kernels/build.py hashes every
// csrc/*.cuh into each library's name, so editing this file rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NJ = 12;           // joints of the Franka-Ridgeback chain
constexpr int N_LINKS = 8;       // collision links: pivot, panda_link1..7
constexpr int N_FRAMES = N_LINKS + 2;  // + end effector + arm mount
constexpr int N_PAIRS = 20;      // self-collision pairs
constexpr float FRICTION_EPS = 1e-3f;
constexpr float BARRIER_MAXIMUM = 1e10f;
// Dynamic shared memory one block of an H100 can use (opt-in above 48 KB):
// what bounds the horizon of a kernel that keeps per-step tables there.
constexpr int MAX_SHARED_BYTES = 232448;

// Per-step table columns the cost terms read (every rollout kernel's table starts so).
constexpr int COL_TARGET = 0;    // 3: clamped trajectory target
constexpr int COL_INV2 = 3;      // 1 / |target|^2 (0 when inactive)
constexpr int COL_PCOST = 4;     // position cost constant
constexpr int COL_VTARGET = 5;   // velocity target
constexpr int COL_DISC = 6;      // discount^s

// Topology: base x, base y, pivot, panda_joint1..7, two fingers on the hand.
__host__ __device__ constexpr int parent_of(int j) {
  return j == 0 ? -1 : (j <= 9 ? j - 1 : 9);
}
__host__ __device__ constexpr bool revolute(int j) { return j >= 2 && j <= 9; }
// Whether joint j moves body b (j is b or an ancestor of b).
__host__ __device__ constexpr bool moves(int j, int b) {
  return j == b || (j < b && j <= 9);
}
// Moving body of frame f: collision links sit on bodies 2..9, the end
// effector on body 9 (panda_link7 composite), the arm mount on body 2.
__host__ __device__ constexpr int frame_body(int f) {
  return f < N_LINKS ? f + 2 : (f == N_LINKS ? 9 : 2);
}
constexpr int EE_FRAME = N_LINKS;
constexpr int MOUNT_FRAME = N_LINKS + 1;
constexpr int EE_BODY = 9;
// Self-collision pairs (a, b): a = 0..5, b = max(3, a + 2)..7.
__host__ __device__ constexpr int pair_first_b(int a) { return a + 2 > 3 ? a + 2 : 3; }

struct Params {
  float rot[NJ][9];        // fixed rotation parent link -> joint frame
  float trans[NJ][3];      // fixed translation parent link -> joint frame
  float axis[NJ][3];       // unit joint axis in the joint frame
  float mass[NJ];
  float com[NJ][3];        // composite COM in the link frame
  float inertia[NJ][9];    // composite inertia about the COM, link axes
  float kd[NJ];
  float kd_dt[NJ];         // kd * dt, rounded once from double
  float friction[NJ];
  float damping[NJ];
  float frame_p[N_FRAMES][3];  // frame translations in their body
  float lower_bound[NJ];
  float lower_scale[NJ];
  float upper_bound[NJ];
  float upper_scale[NJ];
  float pair_radius[N_PAIRS];  // radius_a + radius_b, rounded once from double
  float collision_bound, collision_scale;
  float infront_bound, infront_scale;
  float reach_bound, reach_scale;
  float above_bound, above_scale;
  float yaw_gain;
  float energy_below_bound, energy_below_scale;
  float energy_above_bound, energy_above_scale;
  float velocity_gain[NJ];
  float trajectory_velocity_quadratic;
  float manipulability_quadratic;
  float dt;
  int enable_joint_limit;
  int enable_self_collision;
  int enable_workspace;
  int enable_energy;
  int enable_velocity;
  int enable_trajectory;
  int enable_manipulability;
};

// Clip that lets NaN through, like jnp.clip / torch.clamp.
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Inverse barrier on a signed gap (positive inside the bound).
__device__ __forceinline__ void barrier(float gap, float scale, float& viol,
                                        float& smooth) {
  const float safe = gap > 0.0f ? gap : 1.0f;
  const float raw = scale / safe;
  const bool outside = gap <= 0.0f;
  const bool clamped = raw >= BARRIER_MAXIMUM;
  viol += (outside || clamped) ? 1.0f : 0.0f;
  smooth += outside ? scale * gap * gap : (clamped ? 0.0f : raw);
}

__device__ __forceinline__ float asin_poly(float v) {
  const float z = v * v;
  float p = 4.2163199048e-2f;
  p = p * z + 2.4181311049e-2f;
  p = p * z + 4.5470025998e-2f;
  p = p * z + 7.4953002686e-2f;
  p = p * z + 1.6666752422e-1f;
  return v + v * z * p;
}

// arccos from the Cephes asinf polynomial, as the TPU kernel computes it.
__device__ __forceinline__ float acos_poly(float x) {
  const float ax = fabsf(x);
  const float h = 0.5f * (1.0f - ax);
  const float s = sqrtf(h < 0.0f ? 0.0f : h);
  const float big = 2.0f * asin_poly(s);
  const float small = 1.57079632679489662f - asin_poly(x);
  return ax > 0.5f ? (x < 0.0f ? 3.14159265358979324f - big : big) : small;
}

__device__ __forceinline__ void mat_mul(const float* A, const float* B, float* C) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      C[3 * a + b] = A[3 * a] * B[b] + A[3 * a + 1] * B[3 + b] + A[3 * a + 2] * B[6 + b];
}

__device__ __forceinline__ void mat_vec(const float* A, const float* x, float* y) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
    y[a] = A[3 * a] * x[0] + A[3 * a + 1] * x[1] + A[3 * a + 2] * x[2];
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// What the first parts of a step leave for the rest: world rotations,
// origins and axes of the joints (forward_kinematics), the end effector's
// linear Jacobian and velocity (step_costs).
struct StepKinematics {
  float Rw[NJ][9], Pw[NJ][3], Aw[NJ][3];
  float J[NJ][3];
  float ee_vel[3];
};

// Forward kinematics of q: the world rotation, origin and axis of every
// joint (K.Rw, K.Pw, K.Aw), which both the cost terms and the dynamics read.
__device__ __forceinline__ void forward_kinematics(const Params& P, const float (&q)[NJ],
                                                   StepKinematics& K) {
  float (&Rw)[NJ][9] = K.Rw;
  float (&Pw)[NJ][3] = K.Pw;
  float (&Aw)[NJ][3] = K.Aw;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int p = parent_of(j);
    float Rj[9], pj[3];
    if (p < 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) Rj[k] = P.rot[j][k];
#pragma unroll
      for (int k = 0; k < 3; ++k) pj[k] = P.trans[j][k];
    } else {
      mat_mul(Rw[p], P.rot[j], Rj);
      mat_vec(Rw[p], P.trans[j], pj);
#pragma unroll
      for (int k = 0; k < 3; ++k) pj[k] += Pw[p][k];
    }
    mat_vec(Rj, P.axis[j], Aw[j]);
    if (revolute(j)) {
      float s, c;
      sincosf(q[j], &s, &c);
      const float omc = 1.0f - c;
      const float* a = P.axis[j];
      // Rodrigues: I + s K + (1 - c) K^2, K = skew(a), K^2 = a a^T - I.
      const float Rm[9] = {
          1.0f + omc * (a[0] * a[0] - 1.0f), -s * a[2] + omc * a[0] * a[1], s * a[1] + omc * a[0] * a[2],
          s * a[2] + omc * a[1] * a[0], 1.0f + omc * (a[1] * a[1] - 1.0f), -s * a[0] + omc * a[1] * a[2],
          -s * a[1] + omc * a[2] * a[0], s * a[0] + omc * a[2] * a[1], 1.0f + omc * (a[2] * a[2] - 1.0f)};
      mat_mul(Rj, Rm, Rw[j]);
#pragma unroll
      for (int k = 0; k < 3; ++k) Pw[j][k] = pj[k];
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) Rw[j][k] = Rj[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) Pw[j][k] = pj[k] + q[j] * Aw[j][k];
    }
  }
}

// The cost terms before the trajectory term on forward_kinematics' K: joint
// limits, self collision, workspace, energy, velocity. Sets viol and smooth,
// and K's end-effector Jacobian and velocity.
__device__ __forceinline__ void step_costs(const Params& P, const float (&q)[NJ],
                                           const float (&v)[NJ], float energy,
                                           StepKinematics& K, float& viol, float& smooth) {
  const float (&Rw)[NJ][9] = K.Rw;
  const float (&Pw)[NJ][3] = K.Pw;
  const float (&Aw)[NJ][3] = K.Aw;
  float frame[N_FRAMES][3];
#pragma unroll
  for (int f = 0; f < N_FRAMES; ++f) {
    const int b = frame_body(f);
    mat_vec(Rw[b], P.frame_p[f], frame[f]);
#pragma unroll
    for (int k = 0; k < 3; ++k) frame[f][k] += Pw[b][k];
  }
  const float* ee = frame[EE_FRAME];

  viol = 0.0f;
  smooth = 0.0f;

  // --- joint limits ---------------------------------------------------------
  if (P.enable_joint_limit) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      barrier(q[j] - P.lower_bound[j], P.lower_scale[j], viol, smooth);
      barrier(P.upper_bound[j] - q[j], P.upper_scale[j], viol, smooth);
    }
  }

  // --- self collision -------------------------------------------------------
  if (P.enable_self_collision) {
    int pair = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = pair_first_b(a); b < N_LINKS; ++b, ++pair) {
        const float dx = frame[a][0] - frame[b][0];
        const float dy = frame[a][1] - frame[b][1];
        const float dz = frame[a][2] - frame[b][2];
        const float gap = sqrtf(dx * dx + dy * dy + dz * dz) - P.pair_radius[pair];
        barrier(gap - P.collision_bound, P.collision_scale, viol, smooth);
      }
    }
  }

  // --- end-effector linear Jacobian and velocity ----------------------------
  float (&J)[NJ][3] = K.J;
  float (&ee_vel)[3] = K.ee_vel;
  ee_vel[0] = ee_vel[1] = ee_vel[2] = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (!moves(j, EE_BODY)) {
      J[j][0] = J[j][1] = J[j][2] = 0.0f;
      continue;
    }
    if (revolute(j)) {
      const float r[3] = {ee[0] - Pw[j][0], ee[1] - Pw[j][1], ee[2] - Pw[j][2]};
      cross(Aw[j], r, J[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) J[j][k] = Aw[j][k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) ee_vel[k] += J[j][k] * v[j];
  }

  // --- workspace --------------------------------------------------------------
  if (P.enable_workspace) {
    float sy, cy;
    sincosf(q[2], &sy, &cy);
    const float* mount = frame[MOUNT_FRAME];
    const float robot[3] = {mount[0] + 0.1f * cy, mount[1] + 0.1f * sy, mount[2] + 0.15f};
    const float to_ee[3] = {ee[0] - robot[0], ee[1] - robot[1], ee[2] - robot[2]};
    const float projection = to_ee[0] * cy + to_ee[1] * sy;
    barrier(projection - P.infront_bound, P.infront_scale, viol, smooth);
    const float reach = sqrtf(to_ee[0] * to_ee[0] + to_ee[1] * to_ee[1] + to_ee[2] * to_ee[2]);
    barrier(P.reach_bound - reach, P.reach_scale, viol, smooth);
    const float denom = sqrtf(to_ee[0] * to_ee[0] + to_ee[1] * to_ee[1]);
    const float angle = acos_poly(clip(projection / (denom > 0.0f ? denom : 1.0f), -1.0f, 1.0f));
    smooth += denom > 0.0f ? P.yaw_gain * angle * angle : 0.0f;
    barrier((ee[2] - robot[2]) - P.above_bound, P.above_scale, viol, smooth);
  }

  // --- energy (constant over a rollout: no wrench acts in rollouts) ---------
  if (P.enable_energy) {
    barrier(energy - P.energy_below_bound, P.energy_below_scale, viol, smooth);
    barrier(P.energy_above_bound - energy, P.energy_above_scale, viol, smooth);
  }

  // --- velocity cost ----------------------------------------------------------
  if (P.enable_velocity) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (P.velocity_gain[j] != 0.0f) smooth += P.velocity_gain[j] * v[j] * v[j];
  }
}

// --- trajectory cost (per-rollout part): the one term that reads the
// forecast, through the table row ------------------------------------------
__device__ __forceinline__ void add_trajectory_cost(const Params& P, const float (&ee_vel)[3],
                                                    const float* row, float& smooth) {
  if (P.enable_trajectory) {
    const float* target = row + COL_TARGET;
    const float inv2 = row[COL_INV2];
    const float projection = dot(ee_vel, target) * inv2;
    const float signed_speed = projection * sqrtf(dot(target, target));
    const float error = fabsf(row[COL_VTARGET] - signed_speed);
    smooth += row[COL_PCOST] +
              (inv2 > 0.0f ? P.trajectory_velocity_quadratic * error * error : 0.0f);
  }
}

// --- manipulability (arm columns 3..9 of the linear Jacobian): the term a
// step adds after the trajectory term when P.enable_manipulability ---------
__device__ __forceinline__ float manipulability_cost(const Params& P, const float (&J)[NJ][3]) {
  float m00 = 0.0f, m01 = 0.0f, m02 = 0.0f, m11 = 0.0f, m12 = 0.0f, m22 = 0.0f;
#pragma unroll
  for (int j = 3; j < 10; ++j) {
    m00 += J[j][0] * J[j][0];
    m01 += J[j][0] * J[j][1];
    m02 += J[j][0] * J[j][2];
    m11 += J[j][1] * J[j][1];
    m12 += J[j][1] * J[j][2];
    m22 += J[j][2] * J[j][2];
  }
  const float det = m00 * (m11 * m22 - m12 * m12) - m01 * (m01 * m22 - m12 * m02) +
                    m02 * (m01 * m12 - m11 * m02);
  float volume = sqrtf(det < 0.0f ? 0.0f : det);
  volume = volume != volume ? 1e-5f : clip(volume, 1e-5f, 1e5f);  // NaN -> 1e-5
  const float inv = 1.0f / volume;
  return P.manipulability_quadratic * inv * inv;
}

// The dynamics of a step, which no cost term and no forecast feeds: the next
// (q, v) from (q, v, u) and the step's kinematics.
__device__ __forceinline__ void step_dynamics(const Params& P, float (&q)[NJ], float (&v)[NJ],
                                              const float (&u)[NJ], const StepKinematics& K) {
  const float (&Rw)[NJ][9] = K.Rw;
  const float (&Pw)[NJ][3] = K.Pw;
  const float (&Aw)[NJ][3] = K.Aw;
  // --- mass matrix: CRBA with composite inertias at the world origin -------
  // A body's spatial inertia about the origin is (m, h = m c, UL) with
  // UL = R I R^T + m (|c|^2 I - c c^T); composites are sums of these.
  float Im[NJ], Ih[NJ][3], IU[NJ][6];
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const float m = P.mass[k];
    float c[3], T[9];
    mat_vec(Rw[k], P.com[k], c);
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] += Pw[k][a];
    mat_mul(Rw[k], P.inertia[k], T);
    const float cc = dot(c, c);
    int e = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b, ++e) {
        const float world = T[3 * a] * Rw[k][3 * b] + T[3 * a + 1] * Rw[k][3 * b + 1] +
                            T[3 * a + 2] * Rw[k][3 * b + 2];
        IU[k][e] = world + m * ((a == b ? cc : 0.0f) - c[a] * c[b]);
      }
    Im[k] = m;
#pragma unroll
    for (int a = 0; a < 3; ++a) Ih[k][a] = m * c[a];
  }
#pragma unroll
  for (int k = NJ - 1; k > 0; --k) {
    const int p = parent_of(k);
    Im[p] += Im[k];
#pragma unroll
    for (int a = 0; a < 3; ++a) Ih[p][a] += Ih[k][a];
#pragma unroll
    for (int e = 0; e < 6; ++e) IU[p][e] += IU[k][e];
  }

  // Motion subspaces S_j = [w; lin]: revolute [axis; origin x axis],
  // prismatic [0; axis].
  float Sw[NJ][3], Sv[NJ][3];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (revolute(j)) {
#pragma unroll
      for (int k = 0; k < 3; ++k) Sw[j][k] = Aw[j][k];
      cross(Pw[j], Aw[j], Sv[j]);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        Sw[j][k] = 0.0f;
        Sv[j][k] = Aw[j][k];
      }
    }
  }

  float M[NJ * (NJ + 1) / 2];  // lower triangle, then its Cholesky factor
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    // F = I^c_i S_i: top = UL w + h x v, bottom = w x h + m v.
    const float* U = IU[i];
    const float* w = Sw[i];
    const float* lin = Sv[i];
    float hv[3], wh[3];
    cross(Ih[i], lin, hv);
    cross(w, Ih[i], wh);
    const float Ft[3] = {U[0] * w[0] + U[1] * w[1] + U[2] * w[2] + hv[0],
                         U[1] * w[0] + U[3] * w[1] + U[4] * w[2] + hv[1],
                         U[2] * w[0] + U[4] * w[1] + U[5] * w[2] + hv[2]};
    const float Fb[3] = {wh[0] + Im[i] * lin[0], wh[1] + Im[i] * lin[1],
                         wh[2] + Im[i] * lin[2]};
#pragma unroll
    for (int j = 0; j <= i; ++j)
      M[tri(i, j)] = moves(j, i) ? dot(Sw[j], Ft) + dot(Sv[j], Fb) : 0.0f;
  }

  // --- implicit PD + friction, Cholesky solve, semi-implicit Euler ---------
  // tau = kd (v_cmd - v) + S_arm u: base velocity commands, arm torques; the
  // gripper position term vanishes and base kp = 0.
  float tau[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    tau[j] = P.kd[j] * ((j < 3 ? u[j] : 0.0f) - v[j]);
    if (j >= 3 && j < 10) tau[j] += u[j];
    M[tri(j, j)] += P.kd_dt[j];
    if (P.friction[j] != 0.0f || P.damping[j] != 0.0f) {
      const float c = P.friction[j] / (fabsf(v[j]) + FRICTION_EPS) + P.damping[j];
      tau[j] -= c * v[j];
      M[tri(j, j)] += c * P.dt;
    }
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float acc = M[tri(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) acc -= M[tri(j, k)] * M[tri(j, k)];
    const float d = sqrtf(acc);
    const float inv = 1.0f / d;
    M[tri(j, j)] = d;
#pragma unroll
    for (int i = j + 1; i < NJ; ++i) {
      float s = M[tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= M[tri(i, k)] * M[tri(j, k)];
      M[tri(i, j)] = s * inv;
    }
  }
  float y[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    float s = tau[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= M[tri(i, k)] * y[k];
    y[i] = s / M[tri(i, i)];
  }
#pragma unroll
  for (int i = NJ - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < NJ; ++k) s -= M[tri(k, i)] * y[k];
    y[i] = s / M[tri(i, i)];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    v[j] = v[j] + P.dt * y[j];
    q[j] = q[j] + P.dt * v[j];
  }
}

// The compiled topology for the wrappers' check against the model:
// [NJ, parent x NJ, revolute x NJ, N_FRAMES, frame body x N_FRAMES, N_PAIRS,
// (a, b) x N_PAIRS]. Returns the count written, or -1 when `capacity` is too
// small.
inline int write_topology(int* out, int capacity) {
  const int needed = 1 + 2 * NJ + 1 + N_FRAMES + 1 + 2 * N_PAIRS;
  if (capacity < needed) return -1;
  int n = 0;
  out[n++] = NJ;
  for (int j = 0; j < NJ; ++j) out[n++] = parent_of(j);
  for (int j = 0; j < NJ; ++j) out[n++] = revolute(j) ? 1 : 0;
  out[n++] = N_FRAMES;
  for (int f = 0; f < N_FRAMES; ++f) out[n++] = frame_body(f);
  out[n++] = N_PAIRS;
  for (int a = 0; a < 6; ++a)
    for (int b = pair_first_b(a); b < N_LINKS; ++b) {
      out[n++] = a;
      out[n++] = b;
    }
  return n;
}

}  // namespace
