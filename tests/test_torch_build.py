"""``simulation._build``'s cache: a library found built is loaded with the
compiler output it was built with, and one without that output is built
again.  ``nvcc`` is stood in for by a script that compiles the source as C
with the host compiler and prints a ptxas-like line, so the test runs
without the CUDA toolkit; skipped where ``cc`` is missing."""

import shutil
import stat
import sys

import pytest

from hybridq_tpu_torch.simulation import _build

FAKE_NVCC = r'''#!{python}
import subprocess, sys
args = sys.argv[1:]
out, src = args[args.index('-o') + 1], args[-1]
with open({calls!r}, 'a') as f:
    f.write(src + '\n')
print("ptxas info    : Used 7 registers, 0 bytes spill stores, "
      "0 bytes spill loads")
sys.exit(subprocess.run([{cc!r}, '-shared', '-fPIC', '-x', 'c', '-o', out,
                         src]).returncode)
'''


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``_build`` pointed at a ``csrc`` of two tiny C sources and a fresh
    build directory, with ``NVCC`` a stand-in; returns the file that lists
    one line per compiled source."""
    cc = shutil.which('cc') or shutil.which('gcc')
    if cc is None:
        pytest.skip("needs a host C compiler to stand in for nvcc")
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    for name in ('one', 'two'):
        (csrc / f'{name}.cu').write_text(f'int {name}(void) {{ return 1; }}\n')
    calls = tmp_path / 'calls'
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls),
                                     cc=cc))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv('NVCC', str(nvcc))
    monkeypatch.setattr(_build, 'CSRC', csrc)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / '_build')
    monkeypatch.setattr(_build, '_LIBS', {})
    monkeypatch.setattr(_build, 'LOGS', {})
    return calls


def _fresh_process(monkeypatch):
    """What a new process sees: nothing loaded, no compiler output yet."""
    monkeypatch.setattr(_build, '_LIBS', {})
    monkeypatch.setattr(_build, 'LOGS', {})


@pytest.mark.parametrize('drop_log', [False, True])
def test_cached_library_keeps_its_compiler_output(fake_build, monkeypatch,
                                                  drop_log):
    """A second process finds both libraries built and gets their ptxas
    lines without compiling (``drop_log=False``); a library whose log is
    gone is compiled again, so its lines are never missing
    (``drop_log=True``)."""
    libs = _build.build_all()
    assert sorted(libs) == ['one', 'two']
    assert libs['one'].one() == 1
    assert len(fake_build.read_text().splitlines()) == 2
    first = dict(_build.LOGS)
    assert all('Used 7 registers' in log for log in first.values())

    if drop_log:
        _build._target(_build.CSRC / 'two.cu').with_suffix('.log').unlink()
    _fresh_process(monkeypatch)
    assert sorted(_build.build_all()) == ['one', 'two']
    assert _build.LOGS == first
    compiled = fake_build.read_text().splitlines()
    assert len(compiled) == (3 if drop_log else 2)
    if drop_log:
        assert compiled[-1].endswith('two.cu')
