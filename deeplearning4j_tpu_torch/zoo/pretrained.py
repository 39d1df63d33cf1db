"""Pretrained-weight machinery for the model zoo (port of
``deeplearning4j_tpu/zoo/pretrained.py``).

Reference: ``org.deeplearning4j.zoo.ZooModel`` (``initPretrained``,
``pretrainedUrl``, ``pretrainedChecksum``) + ``DL4JResources``
(deeplearning4j-zoo / deeplearning4j-common).  The reference downloads
a zip from ``dl4jResources`` and verifies an adler32/md5 checksum
before restoring; this package keeps the same contract over a *local
repository* protocol and downloads nothing:

- a model repository is a directory tree
  ``<base>/<model-name>/<dataset>.zip`` with a per-model
  ``manifest.json`` carrying sha256 checksums,
- ``DL4JResources.get_base_directory()`` resolves the repository root
  (``DL4J_TPU_RESOURCES`` env var, else
  ``~/.deeplearning4j_tpu/pretrained`` if it exists, else the
  checked-in ``resources/pretrained`` goldens shipped with the repo),
- ``ZooModel.init_pretrained(dataset)`` verifies the checksum and
  restores through ``ModelSerializer`` — corrupted or unknown weights
  fail loudly, exactly like the reference's checksum gate,
- ``export_pretrained`` is the publishing side (mint zip + update
  manifest), used to produce the checked-in goldens and usable by
  anyone hosting their own weight repository.

``http(s)://`` URLs raise a clear error instead of attempting a
download; ``file://`` URLs and plain paths work. The artifacts are
``ModelSerializer`` zips, the JAX package's format, so a repository
either package exported serves both; restores build the network on
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional

#: checked-in golden weights (tiny variants, see tools/mint_goldens.py)
_REPO_GOLDENS = Path(__file__).resolve().parents[2] / "resources" / \
    "pretrained"


class DL4JResources:
    """Resolve where pretrained artifacts live (reference
    ``DL4JResources.getBaseDirectory`` + ``getURL``)."""

    _override: Optional[str] = None

    @classmethod
    def set_base_directory(cls, path: Optional[str]) -> None:
        cls._override = path

    @classmethod
    def get_base_directory(cls) -> Path:
        if cls._override:
            return Path(cls._override)
        env = os.environ.get("DL4J_TPU_RESOURCES")
        if env:
            return Path(env)
        home = Path.home() / ".deeplearning4j_tpu" / "pretrained"
        if home.is_dir():
            return home
        return _REPO_GOLDENS

    @classmethod
    def resolve(cls, url_or_path: str) -> Path:
        """file:// URL or filesystem path → Path; http(s) refused."""
        if url_or_path.startswith(("http://", "https://")):
            raise RuntimeError(
                "the package downloads nothing; host the weights in a "
                "local repository and point DL4J_TPU_RESOURCES (or "
                "file://) at it")
        if url_or_path.startswith("file://"):
            return Path(url_or_path[len("file://"):])
        return Path(url_or_path)


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_path(model_dir: Path) -> Path:
    return model_dir / "manifest.json"


def _load_manifest(model_dir: Path) -> dict:
    mp = _manifest_path(model_dir)
    if not mp.is_file():
        return {}
    return json.loads(mp.read_text())


def export_pretrained(net, model_name: str, dataset: str,
                      base_dir=None, extra_meta: Optional[dict] = None
                      ) -> Path:
    """Publish a trained net as a pretrained artifact: write
    ``<base>/<model_name>/<dataset>.zip`` and record its sha256 in the
    model's manifest.  Returns the artifact path."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.serialization import ModelSerializer

    base = Path(base_dir) if base_dir else \
        DL4JResources.get_base_directory()
    model_dir = base / model_name
    model_dir.mkdir(parents=True, exist_ok=True)
    artifact = model_dir / f"{dataset}.zip"
    ModelSerializer.write_model(net, str(artifact))
    manifest = _load_manifest(model_dir)
    manifest[dataset] = {"file": artifact.name,
                         "sha256": _sha256(artifact),
                         "format": ("graph"
                                    if isinstance(net, ComputationGraph)
                                    else "multilayer"),
                         **(extra_meta or {})}
    _manifest_path(model_dir).write_text(
        json.dumps(manifest, indent=2, sort_keys=True) + "\n")
    return artifact


def _locate(model_name: str, dataset: str, base_dir=None):
    """Manifest lookup + existence check (no hashing)."""
    base = Path(base_dir) if base_dir else \
        DL4JResources.get_base_directory()
    model_dir = base / model_name
    manifest = _load_manifest(model_dir)
    if dataset not in manifest:
        known = sorted(manifest) or "none"
        raise FileNotFoundError(
            f"no pretrained weights for {model_name!r} dataset "
            f"{dataset!r} under {model_dir} (available: {known}); "
            "export with zoo.pretrained.export_pretrained or point "
            "DL4J_TPU_RESOURCES at a weight repository")
    entry = manifest[dataset]
    artifact = model_dir / entry["file"]
    if not artifact.is_file():
        raise FileNotFoundError(
            f"manifest names {entry['file']!r} but it is missing from "
            f"{model_dir}")
    return artifact, entry


def fetch_pretrained(model_name: str, dataset: str, base_dir=None):
    """Locate + checksum-verify a pretrained artifact (the reference's
    download-then-verify, minus the download).  Returns
    ``(artifact_path, manifest_entry)``."""
    artifact, entry = _locate(model_name, dataset, base_dir)
    got = _sha256(artifact)
    if got != entry["sha256"]:
        raise IOError(
            f"checksum mismatch for {artifact}: manifest "
            f"{entry['sha256'][:12]}…, file {got[:12]}… — refusing to "
            "load corrupted weights (reference ZooModel checksum gate)")
    return artifact, entry


class ZooModel:
    """Base for zoo architectures (reference
    ``org.deeplearning4j.zoo.ZooModel``).  Subclasses provide
    ``conf()``/``init()``; this base adds the pretrained plumbing."""

    #: repository key; defaults to the class name
    @classmethod
    def model_name(cls) -> str:
        return cls.__name__

    @classmethod
    def pretrained_available(cls, dataset: str = "default",
                             base_dir=None) -> bool:
        """Manifest + file existence only — no hashing; corruption
        still fails loudly at ``init_pretrained`` time."""
        try:
            _locate(cls.model_name(), dataset, base_dir)
            return True
        except FileNotFoundError:
            return False

    @classmethod
    def init_pretrained(cls, dataset: str = "default", base_dir=None,
                        device="cuda"):
        """Checksum-verify and restore pretrained weights (reference
        ``ZooModel.initPretrained(PretrainedType)``) on ``device``.
        Returns the restored network (MultiLayerNetwork or
        ComputationGraph, whichever the artifact holds)."""
        from deeplearning4j_tpu_torch.serialization import ModelSerializer

        artifact, entry = fetch_pretrained(cls.model_name(), dataset,
                                           base_dir)
        if entry.get("format", "multilayer") == "graph":
            return ModelSerializer.restore_computation_graph(
                str(artifact), device=device)
        return ModelSerializer.restore_multi_layer_network(
            str(artifact), device=device)
