"""Model asset manifests: provenance, acquisition and on-disk verification
(a copy of ``dreamlab_tpu/utils/assets.py`` on the port's model detector).

Each JSON in ``model/Assets/`` names a checkpoint, where it came from, and
which files a serving deployment must place under ``<model_root>/<name>/``.

Layout contract
---------------
``layout: "diffusers"`` -- a directory named after the manifest under the
model root, containing the listed relative paths (``loader.py`` reads the
per-component directories). ``layout: "single-file"`` -- one
``.safetensors``/``.ckpt`` at the listed path (``loader_single_file.py``).
The mode system (modes.yaml ``model:`` keys) points at the same names.

There is no downloader: ``plan()`` prints the acquisition commands for an
operator to run where the network is, and ``verify()`` checks a delivered
tree (existence, non-zero size, optional sha256) and that the port's
detector (``utils/model_detector.py``) classifies it as the pipeline the
manifest promises.

CLI: ``python -m dreamlab_tpu_torch.utils.assets --assets model/Assets
--root /models [--verify NAME | --plan NAME | --list]``
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional

_REQUIRED_KEYS = ("name", "repository", "pipeline", "layout", "files")


@dataclasses.dataclass
class AssetFile:
    path: str
    url: Optional[str] = None
    sha256: Optional[str] = None


@dataclasses.dataclass
class AssetManifest:
    name: str
    repository: str
    pipeline: str
    layout: str  # "diffusers" | "single-file"
    files: List[AssetFile]
    description: str = ""
    scale_factor: Optional[float] = None
    capabilities: tuple = ()
    source_path: Optional[str] = None

    @property
    def root_dir(self) -> str:
        """Directory (or file, for single-file) name under the model root."""
        return self.name


def parse_manifest(path: str) -> AssetManifest:
    with open(path) as f:
        raw = json.load(f)
    missing = [k for k in _REQUIRED_KEYS if k not in raw]
    if missing:
        raise ValueError(f"{path}: manifest missing keys {missing}")
    if raw["layout"] not in ("diffusers", "single-file"):
        raise ValueError(f"{path}: unknown layout {raw['layout']!r}")
    files = [
        AssetFile(
            path=e["path"], url=e.get("url"), sha256=e.get("sha256"),
        ) if isinstance(e, dict) else AssetFile(path=e)
        for e in raw["files"]
    ]
    if not files:
        raise ValueError(f"{path}: manifest lists no files")
    return AssetManifest(
        name=raw["name"],
        repository=raw["repository"],
        pipeline=raw["pipeline"],
        layout=raw["layout"],
        files=files,
        description=raw.get("description", ""),
        scale_factor=raw.get("scale_factor"),
        capabilities=tuple(raw.get("capabilities", ())),
        source_path=path,
    )


def load_manifests(assets_dir: str) -> Dict[str, AssetManifest]:
    out: Dict[str, AssetManifest] = {}
    for fn in sorted(os.listdir(assets_dir)):
        if fn.endswith(".json"):
            m = parse_manifest(os.path.join(assets_dir, fn))
            out[m.name] = m
    return out


def plan(manifest: AssetManifest) -> List[str]:
    """Acquisition commands for an operator: one line per file, resolving
    against the manifest's repository when an entry has no explicit url
    (HuggingFace's resolve convention)."""
    lines = [f"# {manifest.name}: {manifest.repository}"]
    base = manifest.repository.rstrip("/")
    for f in manifest.files:
        url = f.url or f"{base}/resolve/main/{f.path}"
        dest = os.path.join(manifest.root_dir, f.path)
        lines.append(f"curl -L --create-dirs -o '{dest}' '{url}'")
    return lines


def verify(
    manifest: AssetManifest, model_root: str, *, check_hashes: bool = False,
    run_detector: bool = True,
) -> List[str]:
    """Return a list of problems (empty == the delivered tree is servable)."""
    problems: List[str] = []
    root = os.path.join(model_root, manifest.root_dir)
    if manifest.layout == "single-file":
        root = model_root
    for f in manifest.files:
        p = os.path.join(root, f.path)
        if not os.path.isfile(p):
            problems.append(f"missing file: {p}")
            continue
        if os.path.getsize(p) == 0:
            problems.append(f"empty file: {p}")
            continue
        if check_hashes and f.sha256:
            h = hashlib.sha256()
            with open(p, "rb") as fh:
                for chunk in iter(lambda: fh.read(1 << 20), b""):
                    h.update(chunk)
            if h.hexdigest() != f.sha256:
                problems.append(f"sha256 mismatch: {p}")
    if problems or not run_detector:
        return problems
    # classification check: the detector must agree with the manifest
    try:
        from .model_detector import detect_model

        target = (
            os.path.join(model_root, manifest.root_dir)
            if manifest.layout == "diffusers"
            else os.path.join(model_root, manifest.files[0].path)
        )
        info = detect_model(target)
        arch = getattr(info, "arch", None)
        if arch and arch not in manifest.pipeline:
            problems.append(
                f"detector classified {target} as arch={arch!r}, manifest "
                f"promises pipeline {manifest.pipeline!r}"
            )
    except Exception as e:  # detector is best-effort here
        problems.append(f"detector check failed: {e}")
    return problems


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--assets", default="model/Assets")
    ap.add_argument("--root", default=os.environ.get("MODEL_ROOT", "/models"))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--plan", metavar="NAME")
    ap.add_argument("--verify", metavar="NAME")
    ap.add_argument("--check-hashes", action="store_true")
    args = ap.parse_args(argv)

    manifests = load_manifests(args.assets)
    if args.list or not (args.plan or args.verify):
        for m in manifests.values():
            print(f"{m.name}\t{m.pipeline}\t{m.layout}\t{len(m.files)} files")
        return 0
    if args.plan:
        print("\n".join(plan(manifests[args.plan])))
        return 0
    problems = verify(
        manifests[args.verify], args.root, check_hashes=args.check_hashes
    )
    if problems:
        print("\n".join(problems))
        return 1
    print(f"{args.verify}: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
