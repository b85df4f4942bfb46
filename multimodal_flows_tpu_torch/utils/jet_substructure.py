"""ctypes bindings for the native jetkit substructure kernels (PyTorch
port's copy of `multimodal_flows_tpu/utils/jet_substructure.py`; host code,
no device path).

`native/jetkit.cpp` at the root of the checkout is host C++ / OpenMP, shared
by both packages as it is: exclusive-kt WTA clustering, N-subjettiness
tau1/2/3, energy correlators C1/D2, flavor ECFs and charge dipoles over
jets.  At first use the host compiler builds it into
`build/multimodal_flows_tpu_torch/` of the checkout (never beside the
source), named by a hash of the source and the flags, and ctypes loads it;
a toolchain without OpenMP's runtime gets a serial build.  `JETKIT_LIB`
names a library built elsewhere.  Where it cannot be built (no compiler,
read-only tree) a warning is given once and a pure-numpy version
of the same math takes over: its per-jet O(n^3) loops are orders of
magnitude slower, so a silent switch would make a big evaluation look hung.
The numpy version is also what the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "jetkit.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "multimodal_flows_tpu_torch"
# native/Makefile's flags but -march=native (a library left in build/ must
# load on another host's CPU), tried with OpenMP first and then without:
# the source guards its OpenMP pragmas, and some toolchains lack libgomp
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
FLAG_SETS = (CXX_FLAGS + ("-fopenmp",), CXX_FLAGS)

_F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def _lib_path(flags) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libjetkit_{digest}.so"


def _find_lib() -> Optional[str]:
    """The library's path: `JETKIT_LIB`, one built before from this
    source, or a fresh build; None when there is no way to one."""
    env = os.environ.get("JETKIT_LIB", "")
    if env and os.path.exists(env):
        return env
    if not SOURCE.exists():
        _warn_fallback(f"{SOURCE} not found")
        return None
    for flags in FLAG_SETS:
        if _lib_path(flags).exists():
            return str(_lib_path(flags))
    return _try_build()


def _try_build() -> Optional[str]:
    """Compile `native/jetkit.cpp` (about 2 s) with the first of FLAG_SETS
    the toolchain accepts; when none does, warn once and return None."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        _warn_fallback("no C++ compiler found")
        return None
    detail = ""
    for flags in FLAG_SETS:
        out = _lib_path(flags)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            out.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)], check=True, timeout=120,
                           stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            os.replace(tmp, out)
            return str(out)
        except (OSError, subprocess.SubprocessError) as e:
            detail = e.__class__.__name__
            if isinstance(e, subprocess.CalledProcessError) and e.stderr:
                detail += ": " + e.stderr.decode(errors="replace").strip()[-200:]
    _warn_fallback(f"building {SOURCE.name} with {cxx} failed ({detail})")
    return None


def _warn_fallback(reason: str) -> None:
    warnings.warn(
        f"native jetkit build unavailable ({reason}); substructure metrics "
        "fall back to the pure-numpy path, which is orders of magnitude "
        "slower on large jet samples", RuntimeWarning, stacklevel=3)


@functools.lru_cache(maxsize=1)
def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library with its argument types declared, or None (the
    numpy version then runs).  Tried once per process."""
    path = _find_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.jetkit_substructure.argtypes = [
        _F32P, _F32P, _F32P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, _F32P]
    lib.jetkit_substructure.restype = None
    lib.jetkit_ecf2.argtypes = [
        _F32P, _F32P, _F32P, _F32P, _F32P, _F32P,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int, _F32P]
    lib.jetkit_ecf2.restype = None
    lib.jetkit_charge_dipole.argtypes = [
        _F32P, _F32P, _F32P, _F32P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, _F32P]
    lib.jetkit_charge_dipole.restype = None
    return lib


def _c32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


def substructure(pt, eta, phi, R: float = 0.8, beta: float = 1.0,
                 force_numpy: bool = False) -> dict:
    """Per-jet substructure: d0, tau1/2/3, tau21, tau32, c1, d2.

    pt/eta/phi: (n_jets, max_p) padded with pt<=0.  Jets with <3 particles
    yield NaN (`JetFeatures` keeps only the jets of >= 3 particles).
    """
    pt, eta, phi = _c32(pt), _c32(eta), _c32(phi)
    n_jets, max_p = pt.shape
    lib = None if force_numpy else load_library()
    out = np.empty((n_jets, 8), dtype=np.float32)
    if lib is not None:
        lib.jetkit_substructure(pt, eta, phi, n_jets, max_p,
                                np.float32(R), np.float32(beta), out)
    else:
        for j in range(n_jets):
            out[j] = _substructure_numpy(pt[j], eta[j], phi[j], R, beta)
    keys = ["d0", "tau1", "tau2", "tau3", "tau21", "tau32", "c1", "d2"]
    return {k: out[:, i] for i, k in enumerate(keys)}


def ecf2(pt1, eta1, phi1, pt2=None, eta2=None, phi2=None,
         beta: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Auto (pt2 None) or cross 2-point energy correlators per jet."""
    pt1, eta1, phi1 = _c32(pt1), _c32(eta1), _c32(phi1)
    n_jets, max_p = pt1.shape
    mode = 0 if pt2 is None else 1
    if mode == 1:
        pt2, eta2, phi2 = _c32(pt2), _c32(eta2), _c32(phi2)
    else:
        pt2 = eta2 = phi2 = pt1  # unused
    lib = load_library()
    out = np.empty((n_jets, 2), dtype=np.float32)
    if lib is not None:
        lib.jetkit_ecf2(pt1, eta1, phi1, pt2, eta2, phi2, n_jets, max_p,
                        np.float32(beta), mode, out)
    else:
        for j in range(n_jets):
            out[j] = _ecf2_numpy(pt1[j], eta1[j], phi1[j],
                                 None if mode == 0 else (pt2[j], eta2[j], phi2[j]),
                                 beta)
    return out[:, 0], out[:, 1]


def charge_dipole(pt, eta, phi, charge, kappa: float = 1.0, beta: float = 1.0):
    """Jet charge Q0/Q_kappa and electric-dipole d2 per jet."""
    pt, eta, phi, charge = _c32(pt), _c32(eta), _c32(phi), _c32(charge)
    n_jets, max_p = pt.shape
    lib = load_library()
    out = np.empty((n_jets, 3), dtype=np.float32)
    if lib is not None:
        lib.jetkit_charge_dipole(pt, eta, phi, charge, n_jets, max_p,
                                 np.float32(kappa), np.float32(beta), out)
    else:
        for j in range(n_jets):
            out[j] = _charge_dipole_numpy(pt[j], eta[j], phi[j], charge[j], kappa, beta)
    return out[:, 0], out[:, 1], out[:, 2]


# --------------------------------------------------------------------------
# numpy fallback (same math, per jet)
# --------------------------------------------------------------------------


def _wrap(dphi):
    return (dphi + np.pi) % (2 * np.pi) - np.pi


def _exclusive_kt_axes(pt, eta, phi, R, n_target):
    pts, etas, phis = list(pt), list(eta), list(phi)
    active = [True] * len(pts)
    n_active = len(pts)
    R2 = R * R
    while n_active > n_target:
        best, bi, bj = np.inf, -1, -1
        idx = [i for i, a in enumerate(active) if a]
        for ii, i in enumerate(idx):
            for j in idx[ii + 1:]:
                de = etas[i] - etas[j]
                dp = _wrap(phis[i] - phis[j])
                dij = min(pts[i] ** 2, pts[j] ** 2) * (de * de + dp * dp) / R2
                if dij < best:
                    best, bi, bj = dij, i, j
        if bi < 0:
            break
        hard = bi if pts[bi] >= pts[bj] else bj
        pts[bi], etas[bi], phis[bi] = pts[bi] + pts[bj], etas[hard], phis[hard]
        active[bj] = False
        n_active -= 1
    return [(pts[i], etas[i], phis[i]) for i, a in enumerate(active) if a]


def _substructure_numpy(pt, eta, phi, R, beta):
    real = pt > 0
    pt, eta, phi = pt[real], eta[real], phi[real]
    if len(pt) < 3:
        return np.full(8, np.nan, np.float32)
    sum_pt = pt.sum()
    d0 = sum_pt * R**beta

    def tau(n):
        axes = _exclusive_kt_axes(pt, eta, phi, R, n)
        drs = np.stack([np.sqrt((eta - a[1]) ** 2 + _wrap(phi - a[2]) ** 2) ** beta
                        for a in axes], axis=0)
        return float((pt * drs.min(axis=0)).sum() / d0)

    t1, t2, t3 = tau(1), tau(2), tau(3)

    z = pt / sum_pt
    de = eta[:, None] - eta[None, :]
    dp = _wrap(phi[:, None] - phi[None, :])
    dr = np.sqrt(de**2 + dp**2) ** beta
    iu = np.triu_indices(len(pt), 1)
    e2 = float((z[:, None] * z[None, :] * dr)[iu].sum())
    e3 = 0.0
    n = len(pt)
    for a in range(n):
        for b in range(a + 1, n):
            for c in range(b + 1, n):
                e3 += z[a] * z[b] * z[c] * dr[a, b] * dr[a, c] * dr[b, c]
    c1 = e2
    d2v = e3 / e2**3 if e2 > 0 else np.nan
    return np.array([d0, t1, t2, t3,
                     t2 / t1 if t1 > 0 else np.nan,
                     t3 / t2 if t2 > 0 else np.nan,
                     c1, d2v], np.float32)


def _ecf2_numpy(pt1, eta1, phi1, other, beta):
    r1 = pt1 > 0
    p1, e1, f1 = pt1[r1], eta1[r1], phi1[r1]
    if other is None:
        if len(p1) < 2:
            return np.zeros(2, np.float32)
        pt2sum = p1.sum() ** 2
        de = e1[:, None] - e1[None, :]
        dp = _wrap(f1[:, None] - f1[None, :])
        dr = np.sqrt(de**2 + dp**2) ** beta
        iu = np.triu_indices(len(p1), 1)
        ecf = float((p1[:, None] * p1[None, :] * dr)[iu].sum())
        return np.array([ecf / pt2sum, pt2sum], np.float32)
    pt2, eta2, phi2 = other
    r2 = pt2 > 0
    p2, e2_, f2 = pt2[r2], eta2[r2], phi2[r2]
    if len(p1) == 0 or len(p2) == 0:
        return np.zeros(2, np.float32)
    pt2sum = p1.sum() * p2.sum()
    de = e1[:, None] - e2_[None, :]
    dp = _wrap(f1[:, None] - f2[None, :])
    dr = np.sqrt(de**2 + dp**2) ** beta
    ecf = float((p1[:, None] * p2[None, :] * dr).sum())
    return np.array([ecf / pt2sum, pt2sum], np.float32)


def _charge_dipole_numpy(pt, eta, phi, charge, kappa, beta):
    real = pt > 0
    pt, eta, phi, q = pt[real], eta[real], phi[real], charge[real]
    jet_pt = pt.sum()
    if jet_pt <= 0:
        q0, qk = np.nan, np.nan
    else:
        q0 = float(q.sum())
        qk = float((q * pt**kappa).sum() / jet_pt)
    if len(pt) < 2:
        return np.array([q0, qk, np.nan], np.float32)
    de = eta[:, None] - eta[None, :]
    dp = _wrap(phi[:, None] - phi[None, :])
    dr = np.sqrt(de**2 + dp**2) ** beta
    w = (q * pt)[:, None] * (q * pt)[None, :]
    iu = np.triu_indices(len(pt), 1)
    d2 = float((w * dr)[iu].sum() / jet_pt**2)
    return np.array([q0, qk, d2], np.float32)
