"""The kernel build (zuds_tpu_torch/kernels/build.py) with a stand-in for
nvcc, on the CPU: one compile per source for sm_90a, then one link of
every object into the library; a failed compile raises with the
compiler's output and leaves no library."""
import os
import stat

import pytest

from zuds_tpu_torch.kernels import build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$NVCC_LOG"
case "$*" in *"$NVCC_FAIL"*) echo "error in $NVCC_FAIL" >&2; exit 2;; esac
while [ $# -gt 0 ]; do
  if [ "$1" = -o ]; then shift; echo built > "$1"; fi
  shift
done
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / 'cuda' / 'bin' / 'nvcc'
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / 'nvcc.log'
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'cuda'))
    monkeypatch.setenv('NVCC_LOG', str(log))
    monkeypatch.setenv('NVCC_FAIL', 'no-such-source')
    return log


def test_each_source_compiled_then_linked(tmp_path, fake_nvcc):
    out = tmp_path / 'lib' / 'libzuds_kernels.so'
    build._compile(out)
    assert out.read_text() == 'built\n'
    calls = [line.split() for line in fake_nvcc.read_text().splitlines()]
    compiles, link = calls[:-1], calls[-1]
    assert sorted(os.path.basename(c[-1]) for c in compiles) == \
        sorted(build.SOURCES)
    for c in compiles:
        assert '-c' in c and 'arch=compute_90a,code=sm_90a' in c
    assert '-shared' in link
    objs = [a for a in link if a.endswith('.o')]
    assert sorted(os.path.basename(o) for o in objs) == \
        sorted(f'{s}.o' for s in build.SOURCES)
    assert list(out.parent.iterdir()) == [out]   # no temporaries left


def test_failed_compile_raises_with_output(tmp_path, fake_nvcc,
                                           monkeypatch):
    monkeypatch.setenv('NVCC_FAIL', 'apply.cu')
    out = tmp_path / 'lib' / 'libzuds_kernels.so'
    with pytest.raises(RuntimeError, match='error in apply.cu'):
        build._compile(out)
    assert not out.exists()


def test_sources_and_symbols_of_the_per_pair_kernels():
    """The gather warp shares warp.cu with H1, the epilogue has its own
    source; both launchers are declared with their C signatures and every
    declared launcher is defined in a source."""
    from pathlib import Path
    here = Path(build.__file__).resolve().parent
    assert 'subtract.cu' in build.SOURCES and 'warp.cu' in build.SOURCES
    text = {s: (here / s).read_text() for s in build.SOURCES}
    assert 'zuds_warp_gather(' in text['warp.cu']
    assert 'warp_gather_kernel' in text['warp.cu']
    assert 'zuds_subtract_epilogue(' in text['subtract.cu']
    assert len(build.SIGNATURES['zuds_warp_gather']) == 14
    assert len(build.SIGNATURES['zuds_subtract_epilogue']) == 15
    for name in build.SIGNATURES:
        assert any(f'extern "C" int {name}(' in t.replace('\n', ' ')
                   for t in text.values()), name


def test_sources_and_symbols_of_the_scoring_kernels():
    """H12 and H14 share cutouts.cu, H13 has braai.cu; each launcher is
    declared with the argument count its wrapper passes."""
    from pathlib import Path
    here = Path(build.__file__).resolve().parent
    assert {'cutouts.cu', 'braai.cu'} <= set(build.SOURCES)
    cut = (here / 'cutouts.cu').read_text()
    assert 'triplet_cut_kernel' in cut and 'negpix_veto_kernel' in cut
    assert 'conv3x3_kernel' in (here / 'braai.cu').read_text()
    assert len(build.SIGNATURES['zuds_triplet_cut']) == 9
    assert len(build.SIGNATURES['zuds_negpix_veto']) == 9
    assert len(build.SIGNATURES['zuds_braai_conv3x3']) == 12


def test_sources_and_symbols_of_the_zogy_kernels(tmp_path, fake_nvcc,
                                                  monkeypatch):
    """H15-H18 share zogy.cu: it is compiled with the others, its launchers
    are declared with the argument counts their wrappers pass, and a change
    to it changes the build's digest."""
    from pathlib import Path
    here = Path(build.__file__).resolve().parent
    assert 'zogy.cu' in build.SOURCES
    text = (here / 'zogy.cu').read_text()
    for kernel in ('spectral_max_kernel', 'spectral_kernel',
                   'normalize_kernel', 'psf_stamps_kernel', 'psf_clip_kernel'):
        assert kernel in text
    assert len(build.SIGNATURES['zuds_zogy_spectral']) == 16
    assert len(build.SIGNATURES['zuds_zogy_normalize']) == 8
    assert len(build.SIGNATURES['zuds_psf_stamps']) == 11
    assert len(build.SIGNATURES['zuds_psf_clip']) == 8
    build._compile(tmp_path / 'lib' / 'libzuds_kernels.so')
    assert any(line.split()[-1].endswith('zogy.cu')
               for line in fake_nvcc.read_text().splitlines())
    before = build._digest()
    orig = build._HERE
    copy = tmp_path / 'src'
    copy.mkdir()
    for name in build.SOURCES + ('common.cuh',):
        (copy / name).write_bytes((orig / name).read_bytes())
    (copy / 'zogy.cu').write_text(text + '// changed\n')
    monkeypatch.setattr(build, '_HERE', copy)
    assert build._digest() != before


def test_ptxas_report_compiles_one_source_alone(tmp_path, fake_nvcc,
                                                monkeypatch):
    """``ptxas_report`` runs nvcc -Xptxas -v on the one source with the
    library's flags, into a scratch object it removes; a failed compile
    raises with the compiler's output."""
    monkeypatch.setattr(build, '_HERE', tmp_path)
    assert build.ptxas_report('braai.cu') == ''
    (call,) = [line.split() for line in fake_nvcc.read_text().splitlines()]
    assert call[-1] == str(tmp_path / 'braai.cu')
    assert '-Xptxas' in call and call[call.index('-Xptxas') + 1] == '-v'
    assert '-c' in call and 'arch=compute_90a,code=sm_90a' in call
    assert list((tmp_path / '_build').iterdir()) == []
    monkeypatch.setenv('NVCC_FAIL', 'braai.cu')
    with pytest.raises(RuntimeError, match='error in braai.cu'):
        build.ptxas_report('braai.cu')
