"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each kernel source under ``handyrl_tpu_torch/csrc/`` has a plain C
interface and compiles on its own into a shared library for ``sm_90a``
(Hopper). Nothing is built at import: the first wrapper call (or
:func:`build`, which starts one ``nvcc`` per source, all at once) compiles
into ``handyrl_tpu_torch/_build/``. Library names carry a hash of the
source, so an edited kernel is never served by a stale build, and each
library is renamed into place only when complete, so processes that build
at the same time never load half a file. A failed build raises with the
compiler's output: there is no fallback. A build is a
``telemetry.compile_scope('kernel_build')``: counted and timed, and after
steady state seen by the retrace sentinel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, Optional

from .. import telemetry

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(PACKAGE_DIR, '_build')

# kernel name -> source file under csrc/
SOURCES = {'geese_trunk': 'geese_trunk.cu', 'targets': 'targets.cu'}

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'))
    candidates += [shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError('nvcc not found (looked at $CUDA_HOME/bin, PATH and '
                       '/usr/local/cuda/bin): the CUDA kernels cannot be built')


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, SOURCES[name]), 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, 'lib%s-%s.so' % (name, digest))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel (default: all) that has no current
    library, one ``nvcc`` process per source, all started together.
    Returns ``{name: seconds}`` for the libraries built by this call; the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<library>.log``."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    with telemetry.compile_scope('kernel_build', ','.join(todo)):
        return _build(todo)


def _build(todo) -> Dict[str, float]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.monotonic()
    for name in todo:
        fd, tmp = tempfile.mkstemp(prefix='lib%s.' % name, suffix='.so.tmp',
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    seconds, failures = {}, []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0].decode('utf-8', 'replace')
        seconds[name] = time.monotonic() - t0
        dest = library_path(name)
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append('%s (exit %d):\n%s' % (name, proc.returncode, log))
            continue
        with open(dest + '.log', 'w') as f:
            f.write(log)
        os.replace(tmp, dest)
    if failures:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output from the build of ``name``'s current library."""
    with open(library_path(name) + '.log') as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(library_path(name))
        return _LIBS[name]
