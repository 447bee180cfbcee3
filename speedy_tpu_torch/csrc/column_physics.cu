// Column physics for Hopper (sm_90a): the whole grid-point physics chain of
// the model in one kernel, one thread per (lat, lon) column.
//
// Replaces: the Pallas TPU kernel
//   speedy_tpu/models/physics/fused.py::fused_grid_physics (body _kernel),
// which ran speedy_tpu.models.physics.grid_physics_core on latitude tiles.
// Its plain PyTorch twin is speedy_tpu_torch.models.physics.grid_physics_core;
// the wrapper is speedy_tpu_torch/models/physics/fused.py.
//
// Chain per column: humidity -> convection -> large-scale condensation ->
// [clouds + shortwave fluxes + LW transmissivities, SW steps only] -> LW
// down -> surface fluxes and land skin temperature -> LW up -> vertical
// diffusion, with the surface fluxes injected at level kx.
//
// What bounds it: the kernel is memory-bound. Per call at T30 (kx=8, 48x96
// columns) it reads 3 [kx] fields, the lowest-level winds, 11 surface
// fields and (non-SW steps) the carried radiation state, and writes 21 (27
// on SW steps) outputs: about 0.65 M values, ~2.6 MB in fp32, ~0.78 us at
// 3.35 TB/s. The arithmetic is a few thousand operations per column, far
// below the card's rate.
//
// Design: one thread per column, so the level sweeps are plain loops over
// registers/local arrays, and the masked static sweeps of the JAX code
// (e.g. convection's itop masks) become real branches. Loads and stores
// are coalesced: neighbouring threads own neighbouring columns, and level k
// of a [kx, il, ix] field sits at k*il*ix + column. The small level tables
// and scalars travel in the kernel's argument block. At 4,608 columns the
// grid is only 36 blocks of 128 threads on 132 SMs, so this simple version
// is latency-bound, not bandwidth-bound; register pressure (tau2 alone is
// 4*kx values) spills to local memory. Templates cover fp32/fp64, kx in
// {5, 7, 8} and the SW / non-SW variants.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math),
// loaded with ctypes through column_physics_launch() below.

#include <cuda_runtime.h>

namespace {

constexpr int MAXL = 9;       // slots per level table (kx + 1 at most)
constexpr int N_IN = 27;
constexpr int N_OUT = 27;

// physical constants (speedy_tpu_torch/constants.py)
constexpr double CP = 1004.0;
constexpr double AKAP = 2.0 / 7.0;
constexpr double RGAS = AKAP * CP;
constexpr double ALHC = 2501.0;
constexpr double SBC = 5.67e-8;
constexpr double P0 = 1.0e5;
// convection.py
constexpr double PSMIN = 0.8, RHBL = 0.9, RHIL = 0.7, SMF = 0.8, FQMAX = 5.0;
// condensation.py
constexpr double RTLSC = 1.0 / (4.0 * 3600.0);
// shortwave.py
constexpr double RHCL1 = 0.30, RHCL2 = 1.00, QACL = 0.20, WPCL = 0.2,
                 PMAXCL = 10.0, CLSMAX = 0.60, CLSMINL = 0.15,
                 GSE_S0 = 0.25, GSE_S1 = 0.40, ALBCL = 0.43, ALBCLS = 0.50,
                 ABSDRY = 0.033, ABSWV1 = 0.022, ABSWV2 = 15.0,
                 ABSCL1 = 0.015, ABSCL2 = 0.15, ABLWIN = 0.3, ABLWV1 = 0.7,
                 ABLWV2 = 50.0, ABLCL1 = 12.0, ABLCL2 = 0.6, EPSLW = 0.05,
                 EMISFC = 0.98;
// surface.py
constexpr double FWIND0 = 0.95, FTEMP0 = 1.0, CDL = 2.4e-3, CDS = 1.0e-3,
                 CHL = 1.2e-3, CHS = 0.9e-3, VGUST = 5.0, CTDAY = 1.0e-2,
                 DTHETA = 3.0, FSTAB = 0.67, CLAMBDA = 7.0, CLAMBSN = 7.0;
// vertical_diffusion.py
constexpr double REDSHC = 0.5, SEGRAD = 0.1;

// Level tables and scalars, in the order of fused.argument_block.
template <typename T>
struct ColumnTables {
  T fsg[MAXL], dhs[MAXL], sigh[MAXL], wvi2[MAXL], grdsig[MAXL],
      grdscp[MAXL], entr[MAXL], rhref[MAXL], dqmax[MAXL], abs1[MAXL],
      rsig[MAXL], rsig1[MAXL], lscp[MAXL], fvdiq2[MAXL], drh0[MAXL];
  T fm0, t1s_den, eps1, fshcq, fshcse, fvdise;
  int vdif_mask;  // bit k set: moisture diffusion at 1-based level k
};
constexpr int N_TABLES = 15;

struct Pointers {
  const void* in[N_IN];
  void* out[N_OUT];
};

template <typename T> __device__ __forceinline__ T mn(T a, T b) {
  return a < b ? a : b;
}
template <typename T> __device__ __forceinline__ T mx(T a, T b) {
  return a > b ? a : b;
}

// Saturation specific humidity, g/kg (humidity.py get_qsat): p = sig*psa.
template <typename T>
__device__ __forceinline__ T qsat_of(T ta, T sigpsa) {
  const T t0 = T(273.16);
  T es = ta >= t0 ? T(6.108e-3) * exp(T(17.269) * (ta - t0) / (ta - T(35.86)))
                  : T(6.108e-3) * exp(T(21.875) * (ta - t0) / (ta - T(7.66)));
  return T(622.0) * es / (sigpsa - T(0.378) * es);
}

// LW band fractions at nint(ta) (longwave.py _fband_at).
template <typename T>
__device__ __forceinline__ void fband(T ta, T f[4]) {
  T tq = floor(ta + T(0.5));
  tq = mn(mx(tq, T(200.0)), T(320.0));
  const T eps1 = T(1.0 - EPSLW);
  const T d1 = tq - T(247.0), d2 = tq - T(282.0), d3 = tq - T(315.0);
  f[1] = (T(0.148) - T(3.0e-6) * (d1 * d1)) * eps1;
  f[2] = (T(0.356) - T(5.2e-6) * (d2 * d2)) * eps1;
  f[3] = (T(0.314) + T(1.0e-5) * (d3 * d3)) * eps1;
  f[0] = eps1 - f[1] - f[2] - f[3];
}

template <typename T>
__device__ __forceinline__ T band_sum(const T f[4]) {
  return ((f[0] + f[1]) + f[2]) + f[3];
}

template <typename T, int KX, bool SW>
__global__ void __launch_bounds__(128)
column_physics_kernel(Pointers p, ColumnTables<T> c, int il, int ix) {
  const int S = il * ix;  // level stride
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= S) return;
  const int j = col / ix;
  auto in = [&](int i) { return static_cast<const T*>(p.in[i]); };
  auto out = [&](int i) { return static_cast<T*>(p.out[i]); };

  // ---- load the column ----
  T tg[KX], qg[KX], phig[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    tg[k] = in(2)[k * S + col];
    qg[k] = mx(in(3)[k * S + col], T(0.0));
    phig[k] = in(4)[k * S + col];
  }
  const T ua = in(0)[col];  // winds: the lowest level only, [il, ix]
  const T va = in(1)[col];
  const T pslg = in(5)[col], albsfc = in(6)[col], alb_l = in(7)[col],
          alb_s = in(8)[col], snowc = in(9)[col], soilw_am = in(10)[col],
          stl_am = in(11)[col], sst_am = in(12)[col], forog = in(13)[col],
          phis0 = in(14)[col], fmask_l = in(15)[col];
  const T fsol = in(16)[j], ozupp = in(17)[j], ozone = in(18)[j],
          zenit = in(19)[j], stratz = in(20)[j], coa = in(21)[j];
  const T ablco2 = in(22)[0];

  const T psg = exp(pslg);
  const T rps = T(1.0) / psg;
  T se[KX], qsat[KX], rh[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    se[k] = T(CP) * tg[k] + phig[k];
    qsat[k] = qsat_of(tg[k], c.fsg[k] * psg);
    rh[k] = qg[k] / qsat[k];
  }

  // ---- convection (convection.py) ----
  const int nl1 = KX - 1;  // 1-based next-to-lowest level
  int itop;
  T qdif;
  {
    const T mse0 = se[KX - 1] + T(ALHC) * qg[KX - 1];
    const T mse1 = mn(mse0, se[nl1 - 1] + T(ALHC) * qg[nl1 - 1]);
    const T mss0 = mx(mse0, se[KX - 1] + T(ALHC) * qsat[KX - 1]);
    int ktop1 = KX, ktop2 = KX;
    T msthr = T(0.0);
#pragma unroll
    for (int k = 3; k < KX - 2; ++k) {  // 1-based candidate levels
      const int k0 = k - 1;
      const T m0 = se[k0] + T(ALHC) * qsat[k0];
      const T m1 = se[k0 + 1] + T(ALHC) * qsat[k0 + 1];
      const T mss2 = m0 + c.wvi2[k0] * (m1 - m0);
      if (mss0 > mss2 && ktop1 > k) ktop1 = k;
      if (mse1 > mss2 && ktop2 > k) { ktop2 = k; msthr = mss2; }
    }
    const T qthr0 = T(RHBL) * qsat[KX - 1];
    const T qthr1 = T(RHBL) * qsat[nl1 - 1];
    const bool lqthr = qg[KX - 1] > qthr0 && qg[nl1 - 1] > qthr1;
    const bool base_ok = psg > T(PSMIN) && ktop1 < KX;
    const bool deep = base_ok && ktop2 < KX;
    const bool shallow = base_ok && ktop2 >= KX && lqthr;
    itop = (deep || shallow) ? ktop1 : KX + 1;
    qdif = deep ? mx(qg[KX - 1] - qthr0, (mse0 - msthr) / T(ALHC))
                : (shallow ? qg[KX - 1] - qthr0 : T(0.0));
  }
  const bool conv = itop <= KX;
  T dfse[KX], dfqa[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) dfse[k] = dfqa[k] = T(0.0);
  T cbmf = T(0.0), precnv = T(0.0);
  if (conv) {
    const T rdps = T(2.0 / (1.0 - PSMIN));
    const T qmax = mx(T(1.01) * qg[KX - 1], qsat[KX - 1]);
    const T w = c.wvi2[nl1 - 1];
    const T sb = se[nl1 - 1] + w * (se[KX - 1] - se[nl1 - 1]);
    T qb = qg[nl1 - 1] + w * (qg[KX - 1] - qg[nl1 - 1]);
    qb = mn(qb, qg[KX - 1]);
    const T fpsa = psg * mn((psg - T(PSMIN)) * rdps, T(1.0));
    cbmf = c.fm0 * fpsa * mn(qdif / mx(qmax - qb, T(1e-30)), T(FQMAX));
    T fmass = cbmf, fus = cbmf * se[KX - 1], fuq = cbmf * qmax,
      fds = cbmf * sb, fdq = cbmf * qb;
    dfse[KX - 1] = fds - fus;
    dfqa[KX - 1] = fdq - fuq;
#pragma unroll
    for (int k = KX - 1; k >= 2; --k) {  // 1-based, downward
      const int k0 = k - 1;
      const bool mid = k >= itop + 1;
      if (mid) {
        dfse[k0] += fus - fds;
        dfqa[k0] += fuq - fdq;
        const T enmass = c.entr[k - 2] * psg * cbmf;
        const T fmass_n = fmass + enmass;
        const T fus_n = fus + enmass * se[k0];
        const T fuq_n = fuq + enmass * qg[k0];
        const T wk = c.wvi2[k0 - 1];
        const T sb_k = se[k0 - 1] + wk * (se[k0] - se[k0 - 1]);
        const T qb_k = qg[k0 - 1] + wk * (qg[k0] - qg[k0 - 1]);
        const T fds_n = fmass_n * sb_k;
        const T fdq_n = fmass_n * qb_k;
        dfse[k0] += fds_n - fus_n;
        dfqa[k0] += fdq_n - fuq_n;
        const T delq = T(RHIL) * qsat[k0] - qg[k0];
        if (delq > T(0.0)) {
          const T fsq = T(SMF) * cbmf * delq;
          dfqa[k0] += fsq;
          dfqa[KX - 1] += -fsq;
        }
        fmass = fmass_n; fus = fus_n; fuq = fuq_n; fds = fds_n; fdq = fdq_n;
      } else if (k == itop) {
        const T qsatb = qsat[k0] + c.wvi2[k0] * (qsat[k0 + 1] - qsat[k0]);
        const T prec_k = mx(fuq - fmass * qsatb, T(0.0));
        precnv = prec_k;
        dfse[k0] += fus - fds + T(ALHC) * prec_k;
        dfqa[k0] += fuq - fdq - prec_k;
      }
    }
  }
  T ttend[KX], qtend[KX];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    ttend[k] = dfse[k] * rps * c.grdscp[k];
    qtend[k] = dfqa[k] * rps * c.grdsig[k];
  }
  const int icnv = KX - itop;

  // ---- large-scale condensation (condensation.py) ----
  T precls;
  {
    const T tfact = T(ALHC / CP);
    const T psa2 = psg * psg;
    T acc = T(0.0);
    int ktop = KX + 1;
#pragma unroll
    for (int k = 1; k < KX; ++k) {  // level 1 excluded
      const T dqa = c.rhref[k] * qsat[k] - qg[k];
      if (dqa < T(0.0)) {
        const T dq = dqa * T(RTLSC);
        qtend[k] += dq;
        ttend[k] += tfact * mn(-dq, c.dqmax[k] * psa2);
        acc += c.lscp[k - 1] * dq;
        if (ktop > k + 1) ktop = k + 1;
      }
    }
    itop = mn(ktop, itop);
    precls = -acc * psg;
  }

  // ---- radiation: SW (SW steps) or the carried state ----
  T tau2[4][KX], tt_rsw[KX];
  T stratc0, stratc1, ssrd, ssr = T(0.0), tsr = T(0.0);
  if (SW) {
    // clouds (shortwave.py clouds)
    const T gse = (se[KX - 2] - se[KX - 1]) / (phig[KX - 2] - phig[KX - 1]);
    const bool above = rh[nl1 - 1] > T(RHCL1);
    T cloudc = above ? rh[nl1 - 1] - T(RHCL1) : T(0.0);
    int icltop = above ? nl1 : KX + 1;
#pragma unroll
    for (int k = 3; k < KX - 1; ++k) {
      const int k0 = k - 1;
      const T drh = rh[k0] - T(RHCL1);
      if (drh > cloudc && qg[k0] > T(QACL)) { cloudc = drh; icltop = k; }
    }
    const T pr1 = mn(T(86.4) * (precnv + precls), T(PMAXCL));
    const T cc = mn(cloudc * T(1.0 / (RHCL2 - RHCL1)), T(1.0));
    cloudc = mn(T(WPCL) * sqrt(pr1) + cc * cc, T(1.0));
    icltop = itop < icltop ? itop : icltop;
    const T qcloud = qg[nl1 - 1];
    const T fstab =
        mn(mx(T(1.0 / (GSE_S1 - GSE_S0)) * (gse - T(GSE_S0)), T(0.0)), T(1.0));
    T clstr = fstab * mx(T(CLSMAX) - T(1.2) * cloudc, T(0.0));
    const T clstrl = mx(clstr, T(CLSMINL)) * rh[KX - 1];
    clstr = clstr + fmask_l * (clstrl - clstr);

    // SW transmissivities and cloud reflection (shortwave_rad_fluxes)
    const T psaz = psg * zenit;
    const T acloud = cloudc * mn(T(ABSCL1) * qcloud, T(ABSCL2));
    T tau_1[KX], tau_2[KX], refl[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const T a = (k + 1 >= icltop) ? acloud : T(0.0);
      tau_1[k] = exp(-psaz * c.dhs[k] * (c.abs1[k] + T(ABSWV1) * qg[k] + a));
      tau_2[k] = exp(-psaz * c.dhs[k] * T(ABSWV2) * qg[k]);
      refl[k] = (k + 1 == icltop) ? T(ALBCL) * cloudc : T(0.0);
    }
    tau_1[0] = exp(-psaz * c.dhs[0] * T(ABSDRY));
    tau_1[KX - 1] = exp(-psaz * c.dhs[KX - 1] *
                        (c.abs1[KX - 1] + T(ABSWV1) * qg[KX - 1]));
    refl[KX - 1] += T(ALBCLS) * clstr;
    if (icltop == KX) refl[KX - 1] = T(ALBCL) * cloudc * T(0.0) + T(ALBCLS) * clstr;

    // downward pass
    T dfabs[KX], refl_flux[KX];
    T flux1 = fsol * T(1.0 - 0.05);
    T flux2 = fsol * T(0.05);
    T d = flux1;
    flux1 = tau_1[0] * (flux1 - ozupp * psg);
    dfabs[0] = d - flux1;
    d = flux1;
    flux1 = tau_1[1] * (flux1 - ozone * psg);
    dfabs[1] = d - flux1;
    refl_flux[0] = refl_flux[1] = T(0.0);
#pragma unroll
    for (int k0 = 2; k0 < KX; ++k0) {
      const T rk = flux1 * refl[k0];
      refl_flux[k0] = rk;
      flux1 = flux1 - rk;
      d = flux1;
      flux1 = tau_1[k0] * flux1;
      dfabs[k0] = d - flux1;
    }
#pragma unroll
    for (int k0 = 1; k0 < KX; ++k0) {
      dfabs[k0] = dfabs[k0] + flux2;
      flux2 = tau_2[k0] * flux2;
      dfabs[k0] = dfabs[k0] - flux2;
    }
    // surface and upward pass
    ssrd = flux1 + flux2;
    flux1 = flux1 * albsfc;
    ssr = ssrd - flux1;
#pragma unroll
    for (int k0 = KX - 1; k0 >= 0; --k0) {
      dfabs[k0] = dfabs[k0] + flux1;
      flux1 = tau_1[k0] * flux1;
      dfabs[k0] = dfabs[k0] - flux1;
      flux1 = flux1 + refl_flux[k0];
    }
    tsr = fsol - flux1;
#pragma unroll
    for (int k = 0; k < KX; ++k) tt_rsw[k] = dfabs[k] * rps * c.grdscp[k];

    // LW transmissivities (shortwave_radiation.f90:190-228)
    const T aclw = cloudc * T(ABLCL2);
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const T dp = psg * c.dhs[k];
      T lw1 = exp(-dp * T(ABLWIN));
      const T lw2 = exp(-dp * ablco2);
      T lw3 = exp(-dp * T(ABLWV1) * qg[k]);
      T lw4 = exp(-dp * T(ABLWV2) * qg[k]);
      if (k == 0) { lw3 = T(1.0); lw4 = T(1.0); }
      if (k >= 2 && k <= KX - 2) {
        const T acl1 = (k + 1 < icltop) ? aclw : T(ABLCL1) * cloudc;
        lw1 = exp(-dp * (T(ABLWIN) + acl1));
        lw3 = exp(-dp * mx(T(ABLWV1) * qg[k], aclw));
        lw4 = exp(-dp * mx(T(ABLWV2) * qg[k], aclw));
      }
      tau2[0][k] = lw1; tau2[1][k] = lw2; tau2[2][k] = lw3; tau2[3][k] = lw4;
    }
    stratc0 = stratz * psg;
    stratc1 = c.eps1 * psg;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int k = 0; k < KX; ++k) tau2[b][k] = in(23)[(b * KX + k) * S + col];
    stratc0 = in(24)[col];
    stratc1 = in(24)[S + col];
#pragma unroll
    for (int k = 0; k < KX; ++k) tt_rsw[k] = in(25)[k * S + col];
    ssrd = in(26)[col];
  }

  // ---- LW down (longwave.py downward_longwave_vec) ----
  T st4a1[KX], st4a2[KX], dfabs_lw[KX], flux[4];
  {
    T thalf[KX - 1];
#pragma unroll
    for (int k = 0; k < KX - 1; ++k)
      thalf[k] = tg[k] + c.wvi2[k] * (tg[k + 1] - tg[k]);
    st4a2[0] = T(0.75) * tg[0] + T(0.25) * thalf[0];
    st4a2[1] = T(0.50) * tg[1] + T(0.25) * (thalf[0] + thalf[1]);
#pragma unroll
    for (int k = 2; k < nl1; ++k)
      st4a2[k] = T(0.5) * mx(thalf[k] - thalf[k - 1], T(0.0));
    st4a2[KX - 1] = mx(tg[KX - 1] - thalf[nl1 - 1], T(0.0));
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const T x2 = st4a2[k] * st4a2[k];
      st4a1[k] = T(SBC) * (x2 * x2);
      st4a2[k] = T(0.0);
    }
#pragma unroll
    for (int k = 2; k < KX; ++k) {
      const T st3a = T(SBC) * (tg[k] * tg[k] * tg[k]);
      st4a1[k] = st3a * tg[k];
      st4a2[k] = T(4.0) * st3a * st4a2[k];
    }
    T fb[4];
    fband(tg[0], fb);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T emis = T(1.0) - tau2[b][0];
      flux[b] = emis * (fb[b] * (st4a1[0] + emis * st4a2[0]));
    }
    flux[2] = flux[3] = T(0.0);
    dfabs_lw[0] = -(flux[0] + flux[1]);
#pragma unroll
    for (int k = 1; k < KX; ++k) {
      fband(tg[k], fb);
      const T dfa = band_sum(flux);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const T emis = T(1.0) - tau2[b][k];
        const T brad = fb[b] * (st4a1[k] + emis * st4a2[k]);
        flux[b] = tau2[b][k] * flux[b] + emis * brad;
      }
      dfabs_lw[k] = dfa - band_sum(flux);
    }
  }
  T slrd = T(EMISFC) * band_sum(flux);
  {
    const T corlw = T(EPSLW * EMISFC) * st4a1[KX - 1];
    dfabs_lw[KX - 1] = dfabs_lw[KX - 1] - corlw;
    slrd = slrd + corlw;
  }

  // ---- surface fluxes and land skin temperature (surface.py) ----
  const T esbc = T(EMISFC * SBC);
  const T u0 = T(FWIND0) * ua, v0 = T(FWIND0) * va;
  const T dt1 = c.wvi2[KX - 1] * (tg[KX - 1] - tg[nl1 - 1]);
  T t1_l = tg[KX - 1] + dt1;
  T t1_s = t1_l - phis0 * dt1 / c.t1s_den;
  const T t2_s = tg[KX - 1] + phig[KX - 1] / T(CP);
  const T t2_l = t2_s - phis0 / T(CP);
  if (tg[KX - 1] > tg[nl1 - 1]) {
    t1_l = T(FTEMP0) * t1_l + T(1.0 - FTEMP0) * t2_l;
    t1_s = T(FTEMP0) * t1_s + T(1.0 - FTEMP0) * t2_s;
  } else {
    t1_l = tg[KX - 1];
    t1_s = tg[KX - 1];
  }
  const T t0 = t1_s + fmask_l * (t1_l - t1_s);
  const T denvvs0 = (T(P0) * psg / (T(RGAS) * t0)) *
                    sqrt(u0 * u0 + v0 * v0 + T(VGUST * VGUST));

  T tskin = stl_am + T(CTDAY) * sqrt(coa) * ssrd * (T(1.0) - alb_l) * psg;
  const T rdth = T(FSTAB / DTHETA);
  const T dthl = tskin > t2_l ? mn(tskin - t2_l, T(DTHETA))
                              : mx(T(0.5) * (tskin - t2_l), T(-DTHETA));
  const T denvvs1 = denvvs0 * (T(1.0) + dthl * rdth);
  const T cdldv = T(CDL) * denvvs0 * forog;
  const T ustr_l = -cdldv * ua, vstr_l = -cdldv * va;
  const T chlcp = T(CHL * CP);
  T shf_l = chlcp * denvvs1 * (tskin - t1_l);
  const T qsat_skin = qsat_of(tskin, psg);
  T evap_l = T(CHL) * denvvs1 * mx(soilw_am * qsat_skin - qg[KX - 1], T(0.0));

  const T tsk3 = tskin * tskin * tskin;
  const T dslr = T(4.0 * (EMISFC * SBC)) * tsk3;
  T slru_l = esbc * tsk3 * tskin;
  T hfluxn_l = ssrd * (T(1.0) - alb_l) + slrd - (slru_l + shf_l + T(ALHC) * evap_l);
  const T clamb = T(CLAMBDA) + snowc * T(CLAMBSN - CLAMBDA);
  hfluxn_l = hfluxn_l - clamb * (tskin - stl_am);
  const T qsat_skin1 = qsat_of(tskin + T(1.0), psg);
  const T dqsat = evap_l > T(0.0) ? soilw_am * (qsat_skin1 - qsat_skin) : T(0.0);
  const T dtskin =
      hfluxn_l / (clamb + dslr + T(CHL) * denvvs1 * (T(CP) + T(ALHC) * dqsat));
  tskin = tskin + dtskin;
  shf_l = shf_l + chlcp * denvvs1 * dtskin;
  evap_l = evap_l + T(CHL) * denvvs1 * dqsat * dtskin;
  slru_l = slru_l + dslr * dtskin;
  hfluxn_l = clamb * (tskin - stl_am);

  const T tsea = sst_am;
  const T dths = tsea > t2_s ? mn(tsea - t2_s, T(DTHETA))
                             : mx(T(0.5) * (tsea - t2_s), T(-DTHETA));
  const T denvvs2 = denvvs0 * (T(1.0) + dths * rdth);
  const T cdsdv = T(CDS) * denvvs2;
  const T ustr_s = -cdsdv * ua, vstr_s = -cdsdv * va;
  const T shf_s = T(CHS * CP) * denvvs2 * (tsea - t1_s);
  const T evap_s = T(CHS) * denvvs2 * (qsat_of(tsea, psg) - qg[KX - 1]);
  const T tsea2 = tsea * tsea;
  const T slru_s = esbc * (tsea2 * tsea2);
  const T hfluxn_s = ssrd * (T(1.0) - alb_s) + slrd - slru_s + shf_s + T(ALHC) * evap_s;
  auto blend = [&](T a_l, T a_s) { return a_s + fmask_l * (a_l - a_s); };
  const T ustr_w = blend(ustr_l, ustr_s), vstr_w = blend(vstr_l, vstr_s),
          shf_w = blend(shf_l, shf_s), evap_w = blend(evap_l, evap_s),
          slru_w = blend(slru_l, slru_s);
  const T tsfc = blend(stl_am, tsea);
  const T tskin_w = blend(tskin, tsea);

  // ---- LW up (longwave.py upward_longwave_vec) ----
  T olr, slr;
  {
    const T fsfcu = slru_w;
    slr = fsfcu - slrd;
    T fb[4], fl[4], dfa_add[KX];
    fband(tsfc, fb);
#pragma unroll
    for (int b = 0; b < 4; ++b) fl[b] = fb[b] * fsfcu + T(1.0 - EMISFC) * flux[b];
#pragma unroll
    for (int k = 0; k < KX; ++k) dfa_add[k] = T(0.0);
    dfa_add[KX - 1] = T(EPSLW) * fsfcu;
#pragma unroll
    for (int k = KX - 1; k >= 1; --k) {
      fband(tg[k], fb);
      const T pre = band_sum(fl);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const T emis = T(1.0) - tau2[b][k];
        const T brad = fb[b] * (st4a1[k] - emis * st4a2[k]);
        fl[b] = tau2[b][k] * fl[b] + emis * brad;
      }
      dfa_add[k] = dfa_add[k] + pre - band_sum(fl);
    }
    fband(tg[0], fb);
    const T pre = fl[0] + fl[1];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T emis = T(1.0) - tau2[b][0];
      const T brad = fb[b] * (st4a1[0] - emis * st4a2[0]);
      fl[b] = tau2[b][0] * fl[b] + emis * brad;
    }
    dfa_add[0] = dfa_add[0] + pre - (fl[0] + fl[1]);
    const T corlw1 = c.dhs[0] * stratc1 * st4a1[0] + stratc0;
    const T corlw2 = c.dhs[1] * stratc1 * st4a1[1];
    dfa_add[0] = dfa_add[0] - corlw1;
    dfa_add[1] = dfa_add[1] - corlw2;
    olr = corlw1 + corlw2 + band_sum(fl);
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      const T tt_rlw = (dfabs_lw[k] + dfa_add[k]) * rps * c.grdscp[k];
      ttend[k] = ttend[k] + tt_rsw[k] + tt_rlw;
    }
  }

  // ---- vertical diffusion + surface-flux injection
  // (vertical_diffusion.py, physics.f90:192-205) ----
  {
    T ttv[KX], qtv[KX];
#pragma unroll
    for (int k = 0; k < KX; ++k) ttv[k] = qtv[k] = T(0.0);
    const T fcnv = icnv > 0 ? T(REDSHC) : T(1.0);
    const T dmse = se[KX - 1] - se[nl1 - 1] + T(ALHC) * (qg[KX - 1] - qsat[nl1 - 1]);
    const T drh = rh[KX - 1] - rh[nl1 - 1];
    const bool unstable = dmse >= T(0.0);
    const T fluxse = unstable ? fcnv * c.fshcse * dmse : T(0.0);
    ttv[nl1 - 1] += fluxse * c.rsig[nl1 - 1];
    ttv[KX - 1] += -fluxse * c.rsig[KX - 1];
    const T fluxq_sc = (unstable && drh >= T(0.0))
                           ? fcnv * c.fshcq * qsat[KX - 1] * drh : T(0.0);
    const T fluxq_st = (!unstable && drh > c.drh0[KX - 2])
                           ? c.fvdiq2[nl1] * qsat[nl1 - 1] * drh : T(0.0);
    const T fluxq = fluxq_sc + fluxq_st;
    qtv[nl1 - 1] += fluxq * c.rsig[nl1 - 1];
    qtv[KX - 1] += -fluxq * c.rsig[KX - 1];
#pragma unroll
    for (int k = 3; k < KX - 1; ++k) {
      if (!((c.vdif_mask >> k) & 1)) continue;
      const int k0 = k - 1;
      const T drh_k = rh[k0 + 1] - rh[k0];
      if (drh_k >= c.drh0[k0]) {
        const T fq = c.fvdiq2[k] * qsat[k0] * drh_k;
        qtv[k0] += fq * c.rsig[k0];
        qtv[k0 + 1] += -fq * c.rsig[k0 + 1];
      }
    }
#pragma unroll
    for (int k0 = 0; k0 < KX - 1; ++k0) {
      const T se0 = se[k0 + 1] + T(SEGRAD) * (phig[k0] - phig[k0 + 1]);
      if (se[k0] < se0) {
        const T fse = c.fvdise * (se0 - se[k0]);
        ttv[k0] += fse * c.rsig[k0];
        const T down = -(fse * c.rsig1[k0]);
#pragma unroll
        for (int kk = k0 + 1; kk < KX; ++kk) ttv[kk] += down;
      }
    }
    ttv[KX - 1] += shf_w * rps * c.grdscp[KX - 1];
    qtv[KX - 1] += evap_w * rps * c.grdsig[KX - 1];
#pragma unroll
    for (int k = 0; k < KX; ++k) {
      ttend[k] = ttend[k] + ttv[k];
      qtend[k] = qtend[k] + qtv[k];
    }
  }

  // ---- store ----
#pragma unroll
  for (int k = 0; k < KX - 1; ++k) {
    out(0)[k * S + col] = T(0.0);
    out(1)[k * S + col] = T(0.0);
  }
  out(0)[(KX - 1) * S + col] = ustr_w * rps * c.grdsig[KX - 1];
  out(1)[(KX - 1) * S + col] = vstr_w * rps * c.grdsig[KX - 1];
#pragma unroll
  for (int k = 0; k < KX; ++k) {
    out(2)[k * S + col] = ttend[k];
    out(3)[k * S + col] = qtend[k];
  }
  out(4)[col] = precnv;
  out(5)[col] = precls;
  out(6)[col] = cbmf;
  out(7)[col] = slrd;
  out(8)[col] = slr;
  out(9)[col] = olr;
  const T trios[5][3] = {{ustr_l, ustr_s, ustr_w}, {vstr_l, vstr_s, vstr_w},
                         {shf_l, shf_s, shf_w}, {evap_l, evap_s, evap_w},
                         {slru_l, slru_s, slru_w}};
#pragma unroll
  for (int f = 0; f < 5; ++f)
#pragma unroll
    for (int i = 0; i < 3; ++i) out(10 + f)[i * S + col] = trios[f][i];
  out(15)[col] = hfluxn_l;
  out(15)[S + col] = hfluxn_s;
  out(16)[col] = tsfc;
  out(17)[col] = tskin_w;
  out(18)[col] = u0;
  out(19)[col] = v0;
  out(20)[col] = t0;
  if (SW) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int k = 0; k < KX; ++k) out(21)[(b * KX + k) * S + col] = tau2[b][k];
    out(22)[col] = stratc0;
    out(22)[S + col] = stratc1;
#pragma unroll
    for (int k = 0; k < KX; ++k) out(23)[k * S + col] = tt_rsw[k];
    out(24)[col] = ssrd;
    out(25)[col] = ssr;
    out(26)[col] = tsr;
  }
}

template <typename T, int KX, bool SW>
cudaError_t launch(const void* const* ins, void* const* outs,
                   const double* block, int il, int ix, cudaStream_t stream) {
  Pointers p;
  for (int i = 0; i < N_IN; ++i) p.in[i] = ins[i];
  for (int i = 0; i < N_OUT; ++i) p.out[i] = outs[i];
  ColumnTables<T> c;
  T* tables[N_TABLES] = {c.fsg,  c.dhs,   c.sigh,  c.wvi2,  c.grdsig,
                         c.grdscp, c.entr, c.rhref, c.dqmax, c.abs1,
                         c.rsig, c.rsig1, c.lscp,  c.fvdiq2, c.drh0};
  for (int t = 0; t < N_TABLES; ++t)
    for (int k = 0; k < MAXL; ++k) tables[t][k] = T(block[t * MAXL + k]);
  const double* s = block + N_TABLES * MAXL;
  c.fm0 = T(s[0]);
  c.t1s_den = T(s[1]);
  c.eps1 = T(s[2]);
  c.fshcq = T(s[3]);
  c.fshcse = T(s[4]);
  c.fvdise = T(s[5]);
  c.vdif_mask = static_cast<int>(s[6]);
  const int threads = 128;
  const int blocks = (il * ix + threads - 1) / threads;
  column_physics_kernel<T, KX, SW><<<blocks, threads, 0, stream>>>(p, c, il, ix);
  return cudaGetLastError();
}

template <typename T, int KX>
cudaError_t launch_sw(int sw, const void* const* ins, void* const* outs,
                      const double* block, int il, int ix, cudaStream_t st) {
  return sw ? launch<T, KX, true>(ins, outs, block, il, ix, st)
            : launch<T, KX, false>(ins, outs, block, il, ix, st);
}

template <typename T>
cudaError_t launch_kx(int kx, int sw, const void* const* ins,
                      void* const* outs, const double* block, int il, int ix,
                      cudaStream_t st) {
  switch (kx) {
    case 5: return launch_sw<T, 5>(sw, ins, outs, block, il, ix, st);
    case 7: return launch_sw<T, 7>(sw, ins, outs, block, il, ix, st);
    case 8: return launch_sw<T, 8>(sw, ins, outs, block, il, ix, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface. ins/outs: host arrays of 27 device pointers in the order of
// fused.kernel_inputs / fused.output_shapes (unused slots may be null);
// block: the float64 argument block of fused.argument_block. Returns the
// cudaError_t of the launch (0 on success). Does not synchronise.
extern "C" int column_physics_launch(int f64, int kx, int sw, int il, int ix,
                                     const void* const* ins,
                                     void* const* outs, const double* block,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      f64 ? launch_kx<double>(kx, sw, ins, outs, block, il, ix, st)
          : launch_kx<float>(kx, sw, ins, outs, block, il, ix, st);
  return static_cast<int>(err);
}
