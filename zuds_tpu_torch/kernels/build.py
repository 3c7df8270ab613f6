"""Build the CUDA C++ kernels of this package and load them with ctypes.

The ``.cu`` sources beside this file are compiled by ``nvcc`` for
``sm_90a``, one process per source, all started together, and linked into
one shared library with a plain C interface, at first use, into
``_build/<hash of sources and flags>/`` next to the sources (git ignores
it). No ninja, no PyTorch headers: a build takes seconds. Every launcher
returns ``cudaGetLastError()`` and :func:`check` raises on it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ['library', 'library_path', 'check', 'ptxas_report',
           'ApplyParams', 'FilterTaps']

_HERE = Path(__file__).resolve().parent
SOURCES = ('warp.cu', 'background.cu', 'apply.cu', 'deblend.cu',
           'compact.cu', 'stamps.cu', 'median.cu', 'coadd.cu',
           'subtract.cu', 'cutouts.cu', 'braai.cu', 'zogy.cu', 'adam.cu',
           'photometry.cu', 'measure.cu', 'ccl.cu', 'objects.cu',
           'detect_filter.cu')
FLAGS = ('-O3', '-std=c++17', '-gencode', 'arch=compute_90a,code=sm_90a',
         '-Xcompiler', '-fPIC', '-lineinfo')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# capacities of ApplyParams (apply.cu kMaxReg, kMaxTerms)
APPLY_MAX_REG = 256
APPLY_MAX_TERMS = 256


class ApplyParams(ctypes.Structure):
    """H3's by-value parameters (``struct ApplyParams`` in apply.cu)."""
    _fields_ = [('H', _I), ('W', _I), ('K', _I), ('Nm', _I), ('nreg', _I),
                ('wx', _F), ('wy', _F),
                ('cx', _F * APPLY_MAX_REG), ('cy', _F * APPLY_MAX_REG),
                ('pexp', ctypes.c_uint8 * APPLY_MAX_TERMS),
                ('qexp', ctypes.c_uint8 * APPLY_MAX_TERMS)]


# H4g's taps (detect_filter.cu kMaxTaps)
FILTER_MAX_TAPS = 49


class FilterTaps(ctypes.Structure):
    """H4g's filter (``struct FilterTaps`` in detect_filter.cu): its shape
    and its ``n`` nonzero taps in row-major order."""
    _fields_ = [('kh', _I), ('kw', _I), ('n', _I),
                ('dy', _I * FILTER_MAX_TAPS), ('dx', _I * FILTER_MAX_TAPS),
                ('w', _F * FILTER_MAX_TAPS)]


# C signatures: (name, argtypes); every launcher returns int (cudaError_t)
SIGNATURES = {
    # ref, ref2 (or null), mask, u, v, covb, refw, refw2 (or null), refm,
    # cov, H, W, window, stream
    'zuds_warp': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # ref, mask, u, v, covb, refw, refm, cov, H, W, window, order, stream
    'zuds_warp_sep': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # img, valid(u8), back, sigma, n, H, W, box, iters, stream
    'zuds_background_cells': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # ref, kd, bg, model, params (host struct, copied into the launch),
    # stream
    'zuds_apply': (_P, _P, _P, _P, ctypes.POINTER(ApplyParams), _P),
    # e_src, e_dst, e_w (i64), nedge (i64 scalar), ecap, ccap,
    # nlev, max_rounds, bl, stream
    'zuds_deblend_labels': (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # mask(u8), n, size, fill, tile_scratch, out(i64), total(i64), stream
    'zuds_compact': (_P, _I, _I, _L, _P, _P, _P, _P),
    # diff, rms, wok(u8), H, W, nsigma, img, filt, det(u8), stream
    'zuds_detect_filter': (_P, _P, _P, _I, _I, _F, _P, _P, _P, _P),
    # diff, rms, wok(u8), H, W, nsigma, taps (host struct, copied into the
    # launch), img, filt, det(u8), stream
    'zuds_detect_filter_taps': (_P, _P, _P, _I, _I, _F,
                                ctypes.POINTER(FilterTaps), _P, _P, _P, _P),
    # img, H, W, med, sigma, sat, margin, filt, cand(u8), stream
    'zuds_stamp_candidates': (_P, _I, _I, _P, _P, _F, _I, _P, _P, _P),
    # x, ok(u8 or null), center(or null), rows, cols, x row/col strides,
    # ok row/col strides, blocks, iters, scratch, out, stream
    'zuds_frame_median': (_P, _P, _P, _I, _I, _L, _L, _L, _L, _I, _I, _P,
                          _P, _P),
    # img, wgt, mask, cov(u8), scales (or null), coadd, weight, nclip, nexp,
    # omask, N, npix, nsigma, amp_frac, nodata_bit, stream
    'zuds_clipped_combine': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L,
                             _F, _F, _I, _P),
    # img, img2, mask (each or null), u, v, out, out2, outm (each or null),
    # cov, Hs, Ws, Ho, Wo, stream
    'zuds_warp_gather': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _P),
    # sci, model, sci_rms, ref_var, bad(u8), submask (or null), diff, rms,
    # submask_out (or null), n, sentinel, big_rms, bit, contract, stream
    'zuds_subtract_epilogue': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _F,
                               _F, _I, _I, _P),
    # new, ref, sub frames, x0, y0 (int32), N, W, out (N, 63, 63, 3), stream
    'zuds_triplet_cut': (_P, _P, _P, _P, _P, _I, _I, _P, _P),
    # img, W, med, sig (device scalars), x0, y0 (int32), N, veto(u8), stream
    'zuds_negpix_veto': (_P, _I, _P, _P, _P, _P, _I, _P, _P),
    # in, w (HWIO), bias, wsplit (scratch, or null at layer 1), out, N, H,
    # W, Cin, Cout, pool, stream
    'zuds_braai_conv3x3': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # N, R, Pn, Pr (complex64), n, c_r, c_n, f_ref, f_new, f_rn, f_d,
    # dmax (u32 scratch), D, Pd, S, stream
    'zuds_zogy_spectral': (_P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _P,
                           _P, _P, _P, _P),
    # p_d, s, n, f_d, max_blocks, partials (f64, max_blocks), out, stream
    'zuds_zogy_normalize': (_P, _P, _L, _F, _I, _P, _P, _P),
    # img, H, W, xs, ys, valid(u8), S, size, stamps, good0(u8), stream
    'zuds_psf_stamps': (_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P),
    # stamps, good0(u8), S, npix, iters, psf, good(u8), stream
    'zuds_psf_clip': (_P, _P, _I, _I, _I, _P, _P, _P),
    # in, w, bias, wsplit (as above), out, route (u8 or null), mask (u8 or
    # null), keep, N, H, W, Cin, Cout, pool, stream
    'zuds_braai_conv3x3_train': (_P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                                 _I, _I, _I, _P),
    # gy, route, mask, y (each or null), keep, w, wsplit (scratch), gx, N,
    # H, W, Cin, Cout, pool, stream
    'zuds_braai_conv3x3_dgrad': (_P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _P),
    # x, gy, route, mask, y (each or null), keep, partial, out, N, H, W, Cin,
    # Cout, pool, stream
    'zuds_braai_conv3x3_wgrad': (_P, _P, _P, _P, _P, _F, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _P),
    # kind (0 H19, 1 H20), Cin, Cout, pool, W, out (4 x int32): registers,
    # spilled bytes, dynamic shared memory, blocks per SM
    'zuds_braai_backward_resources': (_I, _I, _I, _I, _I, _P),
    # p, g, mu, nu, bc1, bc2, n, b1, 1 - b1, b2, 1 - b2, eps, -lr, stream
    'zuds_adam_step': (_P, _P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F,
                       _P),
    # img, rms, mask (each or null), xs, ys, N, H, W, r, cut, flux,
    # fluxerr, area, flags, oob(u8), w (or null), stream
    'zuds_aperture_photometry': (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P,
                                 _P, _P, _P, _P, _P, _P),
    # a, b, xs, ys, N, H, W, r, cut, sa, sb, stream
    'zuds_aperture_sums': (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P),
    # img, rms, H, W, xs, ys, a, b, theta, fwhm, N, cut, out (11, N), stream
    'zuds_refine_detections': (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                               _I, _P, _P),
    # det(u8), H, W, sweeps, pidx (i64), count (i64 scalar), cap, out
    # (f32), stream
    'zuds_seed_sweeps': (_P, _I, _I, _I, _P, _P, _I, _P, _P),
    # nbr_pos (i64), okb (u8), lab0 (i64), n, parent (i32 scratch), out
    # (i64), stream
    'zuds_ccl_fixpoint': (_P, _P, _P, _I, _P, _P, _P),
    # cid, pidx (i64), vals (f32), mask (i32), wok (u8), thr (f32), debovf
    # (u8), ndet (i64 scalar), cap, H, W, nseg, minarea, max_det, scratch,
    # outf (18, nseg), outi (2, nseg), valid (u8), stream
    'zuds_object_stats': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                          _I, _P, _P, _P, _P, _P),
    # x, y, a, b, theta, peak, thr, flux, npix (f32), flags (i32), valid
    # (u8), nseg, inv_scale, scratch, contrib (f32), tgt (i32), flux, npix,
    # flags, valid out, stream
    'zuds_clean': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P,
                   _P, _P, _P, _P, _P, _P, _P),
}
# host functions: the scratch bytes of H8 (blocks, iters), H26 (cap, nseg)
# and H27 (nseg)
SCRATCH_SIGNATURES = {
    'zuds_frame_median_scratch': (_I, _I),
    'zuds_object_stats_scratch': (_I, _I),
    'zuds_clean_scratch': (_I,),
}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(cuda_home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin and '
                           'PATH); the CUDA kernels need the CUDA toolkit')
    return found


def _digest():
    h = hashlib.sha256()
    for name in SOURCES + ('common.cuh',):
        h.update(name.encode())
        h.update((_HERE / name).read_bytes())
    h.update(' '.join(FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands at once; raise with the output of the first that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc failed ({proc.returncode}):\n'
                          f'{" ".join(cmd)}\n{stdout}\n{stderr}')
    if failed:
        raise RuntimeError(failed[0])


def _compile(out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / f'{s}.o' for s in SOURCES]
        _run_all([[_nvcc(), *FLAGS, '-c', '-o', str(o), str(_HERE / s)]
                  for s, o in zip(SOURCES, objs)])
        tmp_so = Path(tmp) / out.name
        _run_all([[_nvcc(), *FLAGS, '-shared', '-o', str(tmp_so),
                   *map(str, objs)]])
        os.replace(tmp_so, out)     # atomic: a concurrent loader sees all


def library_path():
    """Where :func:`library` builds and loads the library of these sources
    and flags (a later process finds it there and builds nothing)."""
    return _HERE / '_build' / _digest() / 'libzuds_kernels.so'


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built on first call."""
    out = library_path()
    if not out.exists():
        _compile(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in SCRATCH_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    return lib


def ptxas_report(source):
    """ptxas's report (``nvcc -Xptxas -v``) of one source compiled alone
    with the library's flags: per kernel its registers, spills and static
    shared memory. Returns the compiler's stderr."""
    build = _HERE / '_build'
    build.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        proc = subprocess.run(
            [_nvcc(), *FLAGS, '-Xptxas', '-v', '-c', '-o',
             str(Path(tmp) / 'report.o'), str(_HERE / source)],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}) on {source}:\n'
                           f'{proc.stderr}')
    return proc.stderr


def check(err, name):
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')
