"""Versioned model registry: the fleet's source of truth for artifacts
(ref: the JAX package's ``serving/registry.py``; the same layout file for
file, so a version published by either package resolves in the other).

The reference framework's predict path (``src/c_predict_api.cc``) assumes a
fleet of stateless inference workers loading exported symbol+params
artifacts from shared storage. This module is that storage contract made
explicit — a directory layout plus the integrity and atomicity rules a
fleet needs so that N replicas and one publisher never observe a torn or
corrupt model:

    <root>/<model>/
        CURRENT                     # version name, atomically renamed in
        v1/
            model-symbol.json       # HybridBlock.export artifacts
            model-0000.params
            MANIFEST.json           # signature set + metadata + fingerprint
            manifest.json           # per-file SHA-256 (fault.write_manifest)
            DONE                    # completion marker, written last
            aot.bin                 # optional: the AOT signature bundle
            replay.jsonl            # optional: recorded shape traffic
        v2/ ...

Rules, mirrored from ``fault.CheckpointManager`` (same failure model —
publish is a checkpoint of a model):

- **Atomic publish**: artifacts are staged in ``<version>.tmp`` and
  ``os.replace``d into place; ``DONE`` is written last inside the staging
  dir. A reader never sees a half-written version.
- **Atomic pointer**: ``CURRENT`` is a one-line file updated via
  tmp+rename; replicas resolving "current" either see the old version or
  the new one, never a torn read.
- **Verify on read**: ``resolve`` re-checks the SHA-256 manifest before
  handing a version to a server. Corrupt versions are quarantined
  (renamed ``<version>.bad``) and resolution falls back to the newest
  verified version, exactly like ``restore_latest``.
- **GC keeps serving safe**: ``gc(keep=N)`` never deletes the version
  ``CURRENT`` points at.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, env
from ..fault import ManifestError, verify_manifest, write_manifest
from ..log import get_logger

__all__ = ["ModelRegistry", "ResolvedVersion", "RegistryCorruptError",
           "default_registry_root"]

_LOG = get_logger("mxnet_tpu_torch.serving.registry")

#: artifact prefix inside a version dir — fixed so a resolver needs no
#: out-of-band knowledge to build the ``SymbolBlock.imports`` paths
ARTIFACT_PREFIX = "model"
MANIFEST_NAME = "MANIFEST.json"
CURRENT_NAME = "CURRENT"
DONE_NAME = "DONE"
AOT_NAME = "aot.bin"
REPLAY_NAME = "replay.jsonl"

_VERSION_RE = re.compile(r"^v(\d+)$")
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class RegistryCorruptError(ManifestError):
    """A registry version failed content verification (forged/missing
    manifest hash, truncated artifact, missing file). ``resolve``
    quarantines such versions and falls back to the newest verified one;
    a pinned ``resolve(model, version=...)`` surfaces it to the caller."""


def default_registry_root() -> str:
    """The registry root: ``MXTPU_SERVE_REGISTRY`` or ``<cwd>/registry``."""
    root = env.get("MXTPU_SERVE_REGISTRY")
    return root if root else os.path.join(os.getcwd(), "registry")


def _check_name(kind: str, name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise MXNetError(f"registry: invalid {kind} name {name!r} "
                         "(want [A-Za-z0-9][A-Za-z0-9._-]*)")
    return name


def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


class ResolvedVersion:
    """One verified, loadable model version (what ``resolve`` returns)."""

    __slots__ = ("model", "version", "path", "manifest")

    def __init__(self, model: str, version: str, path: str, manifest: dict):
        self.model = model
        self.version = version
        self.path = path
        self.manifest = manifest          # parsed MANIFEST.json

    @property
    def prefix(self) -> str:
        """``SymbolBlock.imports``-style prefix of the artifacts."""
        return os.path.join(self.path, ARTIFACT_PREFIX)

    @property
    def signature(self) -> dict:
        """The closed signature set published with the version:
        ``{input_names, bucket_shapes, batch_sizes?, dtype}``."""
        return self.manifest.get("signature", {})

    @property
    def aot_path(self) -> Optional[str]:
        p = os.path.join(self.path, AOT_NAME)
        return p if os.path.exists(p) else None

    @property
    def replay_path(self) -> Optional[str]:
        p = os.path.join(self.path, REPLAY_NAME)
        return p if os.path.exists(p) else None

    def __repr__(self):
        return f"ResolvedVersion({self.model}/{self.version})"


class ModelRegistry:
    """On-disk versioned model registry with atomic publish / CURRENT
    flip / verified resolve / quarantine / gc.

    Thread/process safety model: many readers, one publisher per model
    (the usual CI/CD shape). All reader-visible transitions are single
    ``os.replace`` calls, so concurrent readers are safe against a
    publisher; two concurrent publishers to the same model may race
    version numbering (last CURRENT flip wins).
    """

    def __init__(self, root: Optional[str] = None):
        self.root = root if root else default_registry_root()
        os.makedirs(self.root, exist_ok=True)

    # -- layout helpers ---------------------------------------------------
    def _model_dir(self, model: str) -> str:
        return os.path.join(self.root, _check_name("model", model))

    def _version_dir(self, model: str, version: str) -> str:
        return os.path.join(self._model_dir(model),
                            _check_name("version", version))

    def models(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(n for n in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, n)))

    def versions(self, model: str) -> List[str]:
        """Complete (DONE-marked) versions, oldest first; quarantined
        ``.bad`` versions excluded."""
        mdir = self._model_dir(model)
        if not os.path.isdir(mdir):
            return []
        out: List[Tuple[int, str]] = []
        for name in os.listdir(mdir):
            m = _VERSION_RE.match(name)
            if m and os.path.exists(os.path.join(mdir, name, DONE_NAME)):
                out.append((int(m.group(1)), name))
        return [name for _, name in sorted(out)]

    def next_version(self, model: str) -> str:
        """The next monotone version name — counts quarantined and
        in-flight versions too, so a republish after quarantine never
        reuses a name a replica may have cached."""
        mdir = self._model_dir(model)
        top = 0
        if os.path.isdir(mdir):
            for name in os.listdir(mdir):
                m = _VERSION_RE.match(name.split(".", 1)[0])
                if m:
                    top = max(top, int(m.group(1)))
        return f"v{top + 1}"

    def current(self, model: str) -> Optional[str]:
        """The version ``CURRENT`` points at (no verification), or None."""
        try:
            with open(os.path.join(self._model_dir(model), CURRENT_NAME)) as f:
                v = f.read().strip()
            return v or None
        except OSError:
            return None

    def set_current(self, model: str, version: str) -> None:
        """Atomically repoint ``CURRENT``; the version must be complete."""
        vdir = self._version_dir(model, version)
        if not os.path.exists(os.path.join(vdir, DONE_NAME)):
            raise MXNetError(
                f"registry: cannot point CURRENT at incomplete version "
                f"{model}/{version}")
        _atomic_write(os.path.join(self._model_dir(model), CURRENT_NAME),
                      version + "\n")

    # -- publish ----------------------------------------------------------
    def publish(self, model: str, net=None, prefix: Optional[str] = None,
                signature: Optional[dict] = None,
                metadata: Optional[dict] = None,
                version: Optional[str] = None,
                set_current: bool = True,
                input_names: Sequence[str] = ("data",)) -> str:
        """Publish one model version; returns the version name.

        Pass ``net`` (a HybridBlock — exported via ``net.export``) or
        ``prefix`` (existing ``prefix-symbol.json`` + ``prefix-0000.params``
        artifacts, copied in). ``signature`` records the closed serving
        signature set (``bucket_shapes``, ``dtype``, optional
        ``batch_sizes``) that deploy-time warmup drives; ``metadata`` is
        free-form and lands in ``MANIFEST.json``.
        """
        if (net is None) == (prefix is None):
            raise MXNetError("registry.publish needs exactly one of "
                             "net= or prefix=")
        mdir = self._model_dir(model)
        os.makedirs(mdir, exist_ok=True)
        if version is None:
            version = self.next_version(model)
        if not _VERSION_RE.match(version):
            # only vN names: anything else collides with the CURRENT
            # pointer / quarantine namespaces and is invisible to
            # versions()/gc()/rollback()
            raise MXNetError(
                f"registry: version must match v<N> (got {version!r})")
        vdir = os.path.join(mdir, version)
        if os.path.exists(vdir):
            raise MXNetError(
                f"registry: version {model}/{version} already exists "
                "(versions are immutable — publish a new one)")
        tmp = f"{vdir}.tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        try:
            art = os.path.join(tmp, ARTIFACT_PREFIX)
            if net is not None:
                net.export(art, epoch=0, input_names=tuple(input_names))
            else:
                for suffix in ("-symbol.json", "-0000.params"):
                    src = f"{prefix}{suffix}"
                    if not os.path.exists(src):
                        raise MXNetError(
                            f"registry.publish: artifact {src} not found "
                            "(need the HybridBlock.export layout)")
                    shutil.copyfile(src, f"{art}{suffix}")
            manifest = {
                "model": model,
                "version": version,
                "created": time.time(),
                "input_names": list(input_names),
                "signature": dict(signature or {}),
                "metadata": dict(metadata or {}),
                "fingerprint": _runtime_fingerprint(),
            }
            with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
                json.dump(manifest, f, indent=1)
            # integrity proof over every artifact (incl. MANIFEST.json),
            # then the completion marker — same discipline as checkpoints
            write_manifest(tmp)
            with open(os.path.join(tmp, DONE_NAME), "w") as f:
                f.write("ok")
            os.replace(tmp, vdir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if set_current:
            self.set_current(model, version)
        _LOG.info("registry: published %s/%s%s", model, version,
                  " (current)" if set_current else "")
        from ..contrib import chaos
        plan = chaos.active()
        if plan is not None:
            plan.on_publish_complete(model, version, vdir)
        self._count("publish")
        return version

    def attach(self, model: str, version: str, name: str, src: str) -> None:
        """Attach a sidecar file (AOT bundle, replay log) to a published
        version. Sidecars are added to the integrity manifest so resolve
        verifies them too; the attach itself is atomic (tmp+rename)."""
        vdir = self._version_dir(model, version)
        if not os.path.exists(os.path.join(vdir, DONE_NAME)):
            raise MXNetError(f"registry: {model}/{version} is not complete")
        dst = os.path.join(vdir, name)
        tmp = f"{dst}.tmp.{os.getpid()}"
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)
        write_manifest(vdir, exclude=(DONE_NAME,))

    # -- resolve / verify -------------------------------------------------
    def verify(self, model: str, version: str) -> dict:
        """Content-verify one version; returns the parsed MANIFEST.json.
        Raises :class:`RegistryCorruptError` on any failure."""
        vdir = self._version_dir(model, version)
        label = f"registry {model}/{version}"
        if not os.path.exists(os.path.join(vdir, DONE_NAME)):
            raise RegistryCorruptError(
                f"{label} is missing or incomplete (no DONE)")
        # unlike legacy checkpoints, registry versions ALWAYS carry a
        # manifest — a missing one is corruption, not a legacy layout
        verify_manifest(vdir, label=label, error_cls=RegistryCorruptError,
                        required=True)
        try:
            with open(os.path.join(vdir, MANIFEST_NAME)) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise RegistryCorruptError(
                f"{label}: unreadable {MANIFEST_NAME}: {e}") from e

    def _quarantine(self, model: str, version: str, reason: str) -> str:
        vdir = self._version_dir(model, version)
        bad = f"{vdir}.bad"
        i = 0
        while os.path.exists(bad):
            i += 1
            bad = f"{vdir}.bad{i}"
        try:
            os.replace(vdir, bad)
        except FileNotFoundError:
            # another replica quarantined it first — same outcome
            return bad
        _LOG.warning("registry: quarantined corrupt version %s/%s -> %s "
                     "(%s)", model, version, os.path.basename(bad), reason)
        self._count("quarantine")
        return bad

    def resolve(self, model: str, version: str = "current"
                ) -> ResolvedVersion:
        """Resolve + verify a version for serving.

        ``version="current"`` follows the CURRENT pointer; a corrupt (or
        dangling) target is quarantined and resolution falls back to the
        newest verified version, repointing CURRENT at it — a fleet
        replica restarting against a rotted registry still comes up on
        the best available model. A pinned version raises instead (the
        caller asked for those exact bytes).
        """
        follow = version == "current"
        if follow:
            pinned = self.current(model)
            if pinned is None:
                # missing CURRENT pointer: fall back to the newest
                # verified version (and restore the pointer)
                _LOG.warning("registry: %s has no CURRENT pointer; "
                             "falling back to newest verified version",
                             model)
                return self._resolve_fallback(model, skip=None)
        else:
            pinned = version
        try:
            manifest = self.verify(model, pinned)
        except RegistryCorruptError as e:
            if os.path.isdir(self._version_dir(model, pinned)):
                self._quarantine(model, pinned, str(e))
            if not follow:
                raise
            _LOG.warning("registry: CURRENT %s/%s failed verification "
                         "(%s); falling back", model, pinned, e)
            return self._resolve_fallback(model, skip=pinned)
        return ResolvedVersion(model, pinned,
                               self._version_dir(model, pinned), manifest)

    def _resolve_fallback(self, model: str, skip: Optional[str]
                          ) -> ResolvedVersion:
        for v in reversed(self.versions(model)):
            if v == skip:
                continue
            try:
                manifest = self.verify(model, v)
            except RegistryCorruptError as e:
                self._quarantine(model, v, str(e))
                continue
            self.set_current(model, v)  # heal the pointer
            return ResolvedVersion(model, v, self._version_dir(model, v),
                                   manifest)
        raise MXNetError(
            f"registry: no verified version of {model!r} available "
            f"(known models: {self.models()})")

    # -- gc / rollback ----------------------------------------------------
    def gc(self, model: str, keep: int = 3) -> List[str]:
        """Delete all but the newest ``keep`` versions (the CURRENT target
        is always kept, even if older). Returns the deleted versions."""
        if keep < 1:
            raise MXNetError("registry.gc: keep must be >= 1")
        cur = self.current(model)
        versions = self.versions(model)
        deleted = []
        for v in versions[:-keep] if keep < len(versions) else []:
            if v == cur:
                continue
            shutil.rmtree(self._version_dir(model, v), ignore_errors=True)
            deleted.append(v)
        if deleted:
            _LOG.info("registry: gc %s: deleted %s", model, deleted)
        return deleted

    def rollback(self, model: str, version: Optional[str] = None) -> str:
        """Repoint CURRENT at ``version`` (default: the newest complete
        version older than the current one). Returns the new current."""
        if version is None:
            cur = self.current(model)
            versions = self.versions(model)
            older = [v for v in versions if cur is None or
                     _version_num(v) < _version_num(cur)]
            if not older:
                raise MXNetError(
                    f"registry: nothing to roll back to for {model!r} "
                    f"(current={cur}, versions={versions})")
            version = older[-1]
        self.verify(model, version)  # never roll back onto corrupt bytes
        self.set_current(model, version)
        _LOG.info("registry: rollback %s -> %s", model, version)
        self._count("rollback")
        return version

    @staticmethod
    def _count(event: str) -> None:
        try:
            from ..telemetry import default_registry
            default_registry().counter(
                "mxtpu_registry_ops_total",
                "Model-registry operations, by kind.",
                label="op").inc(label_value=event)
        except Exception:
            pass


def _version_num(version: str) -> int:
    m = _VERSION_RE.match(version)
    return int(m.group(1)) if m else -1


def _runtime_fingerprint() -> Dict[str, str]:
    """The (torch, CUDA, card) identity AOT bundles and the persistent
    kernel-build cache are keyed by — a replica on a different runtime
    must capture anew, not trust a bundle."""
    from .aot import runtime_fingerprint
    return runtime_fingerprint()
