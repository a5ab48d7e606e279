"""Versioned model registry: named lines, pinned champions, atomic flips.

Copy of ``handyrl_tpu/serving/registry.py`` (same manifest format, and
the version files hold param bytes in flax's layout, which both packages
write and read: either package serves the other's registry). The registry
is the serving tier's source of truth for *which params a name refers
to*:

* **State is one JSON manifest** (``<root>/registry.json``) published with
  the atomic temp+fsync+rename writer (utils/fs.py). Mutations take a
  cross-process file lock plus a per-instance thread lock and re-read the
  manifest under it, so two racing promotes serialize.
* **Data lands before the manifest references it.** ``publish`` writes the
  snapshot bytes + CRC32 sidecar first and only then flips the manifest;
  ``load_snapshot`` re-verifies the CRC on every read.
* **Promote/rollback are single manifest swaps** of a line's ``champion``
  and ``previous`` pair.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from .. import telemetry
from ..fault import Backoff
from ..utils import fs

_LOG = telemetry.get_logger('registry')

MANIFEST_NAME = 'registry.json'
MANIFEST_FORMAT = 1

# default for the serving.lock_timeout knob: how long a mutation waits for
# the cross-process manifest lock before failing loudly instead of hanging
DEFAULT_LOCK_TIMEOUT = 10.0

_m_publishes = telemetry.counter('registry_publishes_total')
_m_promotes = telemetry.counter('registry_promotes_total')
_m_rollbacks = telemetry.counter('registry_rollbacks_total')
_m_lock_timeouts = telemetry.counter('registry_lock_timeouts_total')


class RegistryError(RuntimeError):
    """A resolve/load against the registry cannot be satisfied."""


class RegistryLockTimeout(RegistryError):
    """The cross-process manifest lock could not be acquired within
    ``serving.lock_timeout`` — a peer process is wedged while holding it.
    Raised instead of blocking the caller (e.g. the learner's publish
    hook) forever."""


def parse_spec(spec: str) -> Tuple[str, str]:
    """``'line@selector'`` -> (line, selector); a bare line means its
    champion. Selectors: ``champion``, ``previous``, ``latest``, or an
    exact version identifier."""
    spec = str(spec).strip()
    line, sep, selector = spec.partition('@')
    if not line:
        raise RegistryError('model spec %r names no line' % spec)
    return line, (selector if sep else 'champion') or 'champion'


def _empty_manifest() -> Dict[str, Any]:
    return {'format': MANIFEST_FORMAT, 'lines': {}}


class ModelRegistry:
    """Versioned model lines over one atomic JSON manifest."""

    def __init__(self, root: str,
                 lock_timeout: float = DEFAULT_LOCK_TIMEOUT):
        self.root = os.path.abspath(root)
        self.lock_timeout = float(lock_timeout)
        self._tlock = threading.RLock()
        # (st_mtime_ns, st_size) of the manifest the cache was parsed from;
        # both maps shared by resolve/mutate callers on any thread
        self._cache_stamp: Optional[Tuple[int, int]] = None  # guarded-by: _tlock
        self._cache: Dict[str, Any] = _empty_manifest()      # guarded-by: _tlock

    # -- paths -------------------------------------------------------------

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_NAME)

    def _version_path(self, line: str, version: str) -> str:
        return os.path.join(self.root, line, '%s.ckpt' % version)

    def _abs(self, path: str) -> str:
        return path if os.path.isabs(path) else os.path.join(self.root, path)

    # -- manifest IO -------------------------------------------------------

    def _read(self) -> Dict[str, Any]:
        """Parse the manifest (stat-cached; the atomic writer guarantees a
        whole file). A missing manifest is an empty registry; an unparsable
        one raises — serving from a corrupt manifest would be guessing."""
        with self._tlock:
            try:
                st = os.stat(self.manifest_path)
                stamp = (st.st_mtime_ns, st.st_size)
            except OSError:
                self._cache_stamp = None
                self._cache = _empty_manifest()
                return self._cache
            if stamp == self._cache_stamp:
                return self._cache
            try:
                with open(self.manifest_path, 'r') as f:
                    manifest = json.load(f)
            except ValueError as exc:
                raise RegistryError('registry manifest %s is unparsable '
                                    '(%s)' % (self.manifest_path, exc))
            if not isinstance(manifest, dict) or 'lines' not in manifest:
                raise RegistryError('registry manifest %s has no lines '
                                    'table' % self.manifest_path)
            self._cache_stamp = stamp
            self._cache = manifest
            return manifest

    def _flock(self, lock_fd: int):
        """Acquire the cross-process manifest lock, non-blockingly with
        jittered retries bounded by ``lock_timeout``: a peer that wedged
        while holding the lock must surface as a loud
        :class:`RegistryLockTimeout`, not hang the caller forever."""
        try:
            import fcntl
        except ImportError:           # non-POSIX: thread lock only
            return
        backoff = Backoff(initial=0.02, maximum=0.5, jitter=0.5)
        deadline = time.monotonic() + self.lock_timeout
        while True:
            try:
                fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return
            except OSError:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    _m_lock_timeouts.inc()
                    raise RegistryLockTimeout(
                        'could not acquire the registry manifest lock under '
                        '%s within %.1fs — a peer process is wedged while '
                        'holding it' % (self.root, self.lock_timeout))
                time.sleep(min(backoff.next_delay(), remaining))

    def _mutate(self, fn) -> Any:
        """Serialized read-modify-write of the manifest: thread lock +
        cross-process ``flock`` on a sidecar lock file, fresh re-read under
        the lock, then ONE atomic publish. Two racing promotes therefore
        serialize; a reader at any instant sees a complete manifest."""
        with self._tlock:
            os.makedirs(self.root, exist_ok=True)
            lock_fd = os.open(os.path.join(self.root, '.registry.lock'),
                              os.O_CREAT | os.O_RDWR, 0o644)
            try:
                self._flock(lock_fd)
                self._cache_stamp = None          # force a fresh read
                manifest = self._read()
                out = fn(manifest)
                fs.atomic_write_bytes(
                    self.manifest_path,
                    (json.dumps(manifest, sort_keys=True) + '\n')
                    .encode('utf-8'))
                self._cache_stamp = None
                return out
            finally:
                os.close(lock_fd)     # releases the flock

    # -- publishing --------------------------------------------------------

    def publish(self, line: str, *, snapshot: Optional[Dict[str, Any]] = None,
                path: Optional[str] = None, architecture: Optional[str] = None,
                config: Optional[Dict[str, Any]] = None, steps: int = 0,
                version: Optional[Any] = None, promote: bool = False) -> str:
        """Register one model version on ``line``; returns its version id.

        Exactly one of ``snapshot`` (an engine-style dict whose bytes are
        copied under the registry root with a CRC sidecar) or ``path`` (a
        reference to an existing CRC-sidecar'd checkpoint, e.g. the
        learner's ``models/<epoch>.ckpt``) must be given. The data file is
        fully on disk before the manifest mentions it. ``promote=True``
        additionally flips the line's champion in the SAME manifest swap.
        """
        if (snapshot is None) == (path is None):
            raise RegistryError('publish takes exactly one of snapshot= '
                                'or path=')
        if snapshot is not None:
            architecture = snapshot['architecture']
            config = snapshot.get('config') or config

        def apply(manifest: Dict[str, Any]) -> str:
            entry = manifest['lines'].setdefault(
                line, {'champion': None, 'previous': None, 'next_seq': 1,
                       'versions': {}})
            seq = int(entry.get('next_seq', 1))
            vid = str(version) if version is not None else str(seq)
            if vid in entry['versions']:
                raise RegistryError('version %s@%s already published'
                                    % (line, vid))
            if snapshot is not None:
                dest = self._version_path(line, vid)
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                fs.checksummed_write_bytes(dest, snapshot['params'])
                rel = os.path.relpath(dest, self.root)
            else:
                rel = os.path.abspath(path)
                if architecture is None:
                    raise RegistryError('publish(path=...) requires '
                                        'architecture=')
            meta: Dict[str, Any] = {'path': rel, 'architecture': architecture,
                                    'steps': int(steps), 'seq': seq,
                                    'time': time.time()}
            if config:
                meta['config'] = dict(config)
            entry['versions'][vid] = meta
            entry['next_seq'] = seq + 1
            if promote or entry['champion'] is None:
                entry['previous'] = entry['champion']
                entry['champion'] = vid
            return vid

        vid = self._mutate(apply)
        _m_publishes.inc()
        _LOG.info('registry: published %s@%s (steps %d%s)', line, vid,
                  int(steps), ', promoted' if promote else '')
        return vid

    def promote(self, line: str, version: Any) -> str:
        """Make ``version`` the line's champion — one atomic manifest swap.
        The displaced champion becomes ``previous`` (the rollback target).
        Promoting the current champion is a no-op."""
        vid = str(version)

        def apply(manifest: Dict[str, Any]) -> str:
            entry = manifest['lines'].get(line)
            if entry is None or vid not in entry['versions']:
                raise RegistryError('cannot promote unknown version %s@%s'
                                    % (line, vid))
            if entry['champion'] != vid:
                entry['previous'] = entry['champion']
                entry['champion'] = vid
            return vid

        out = self._mutate(apply)
        _m_promotes.inc()
        _LOG.info('registry: promoted %s@%s to champion', line, vid)
        return out

    def rollback(self, line: str) -> str:
        """Restore the line's previous champion (bit-identically: the
        version's bytes never moved). Returns the restored version id."""
        def apply(manifest: Dict[str, Any]) -> str:
            entry = manifest['lines'].get(line)
            if entry is None:
                raise RegistryError('unknown line %r' % line)
            prev = entry.get('previous')
            if prev is None or prev not in entry['versions']:
                raise RegistryError('line %r has no previous champion to '
                                    'roll back to' % line)
            entry['champion'], entry['previous'] = prev, entry['champion']
            return prev

        out = self._mutate(apply)
        _m_rollbacks.inc()
        _LOG.warning('registry: rolled line %r back to champion %s',
                     line, out)
        return out

    # -- resolution --------------------------------------------------------

    def resolve(self, line: str, selector: str = 'champion'
                ) -> Tuple[str, Dict[str, Any]]:
        """(version id, meta) for one ``line@selector``. Raises
        :class:`RegistryError` when the line/selector names nothing."""
        manifest = self._read()
        entry = manifest['lines'].get(line)
        if entry is None:
            raise RegistryError('unknown model line %r' % line)
        selector = str(selector)
        if selector in ('champion', 'previous'):
            vid = entry.get(selector)
            if vid is None:
                raise RegistryError('line %r has no %s' % (line, selector))
        elif selector == 'latest':
            versions = entry['versions']
            if not versions:
                raise RegistryError('line %r has no versions' % line)
            vid = max(versions, key=lambda v: int(versions[v].get('seq', 0)))
        else:
            vid = selector
        meta = entry['versions'].get(vid)
        if meta is None:
            raise RegistryError('unknown version %s@%s' % (line, vid))
        return vid, dict(meta, path=self._abs(meta['path']))

    def load_snapshot(self, line: str, selector: str = 'champion'
                      ) -> Dict[str, Any]:
        """Engine-style snapshot for ``line@selector`` with the version id
        riding along — bytes re-verified against the CRC sidecar on every
        load, so a torn/corrupt serving set raises instead of serving."""
        vid, meta = self.resolve(line, selector)
        data = fs.read_verified_bytes(meta['path'])
        if data is None:
            raise RegistryError(
                'version %s@%s is unverifiable (%s missing, truncated, or '
                'failing its CRC sidecar)' % (line, vid, meta['path']))
        snap = {'architecture': meta['architecture'], 'params': data,
                'version': vid, 'line': line}
        if meta.get('config'):
            snap['config'] = dict(meta['config'])
        return snap

    # -- introspection -----------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        """Manifest summary: per line, the champion/previous pair and every
        live version's metadata (path made absolute)."""
        manifest = self._read()
        out: Dict[str, Any] = {}
        for line, entry in manifest['lines'].items():
            out[line] = {
                'champion': entry.get('champion'),
                'previous': entry.get('previous'),
                'versions': {vid: dict(meta, path=self._abs(meta['path']))
                             for vid, meta in entry['versions'].items()},
            }
        return out
