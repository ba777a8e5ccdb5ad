"""Pretrained-artifact fetch layer: the reference's model-id registry and cache.

The port's copy of ``r3m_tpu/fetch.py``: the same model-id -> Google-Drive-artifact
mapping and the same ``$R3M_HOME`` (default ``~/.r3m``) ``<folder>/{model.pt,
config.yaml}`` layout, so one cache serves both packages. The fetch is skipped whenever
the cache is already populated (artifacts copied in by the user); otherwise it downloads
with `requests`, imported only then, and raises a clear error on an offline host.
"""

from __future__ import annotations

import os
import re
from os.path import expanduser
from typing import Dict, Tuple

# model-id -> (cache folder, model.pt drive id, config.yaml drive id)
# Drive ids match r3m/__init__.py:46-57 (load_r3m) and :79-94
# (load_r3m_reproduce; the reference's `modelif` typo made the last two
# unreachable — fixed here).
MODEL_REGISTRY: Dict[str, Tuple[str, str, str]] = {
    "resnet50": ("r3m_50", "1Xu0ssuG0N1zjZS54wmWzJ7-nb0-7XzbA", "10jY2VxrrhfOdNPmsFdES568hjjIoBJx8"),
    "resnet34": ("r3m_34", "15bXD3QRhspIRacOKyWPw5y2HpoWUCEnE", "1RY0NS-Tl4G7M1Ik_lOym0b5VIBxX9dqW"),
    "resnet18": ("r3m_18", "1A1ic-p4KtYlKXdXHcV2QV0cUzI4kn0u-", "1nitbHQ-GRorxc7vMUiEHjHWP5N11Jvc6"),
}

REPRODUCE_REGISTRY: Dict[str, Tuple[str, str, str]] = {
    "r3m": ("original_r3m", "1jLb1yldIMfAcGVwYojSQmMpmRM7vqjp9", "1cu-Pb33qcfAieRIUptNlG1AQIMZlAI-q"),
    "r3m_noaug": ("original_r3m_noaug", "1k_ZlVtvlktoYLtBcfD0aVFnrZcyCNS9D", "1hPmJwDiWPkd6GGez6ywSC7UOTIX7NgeS"),
    "r3m_nol1": ("original_r3m_nol1", "1LpW3aBMdjoXsjYlkaDnvwx7q22myM_nB", "1rZUBrYJZvlF1ReFwRidZsH7-xe7csvab"),
    "r3m_nolang": ("original_r3m_nolang", "1FXcniRei2JDaGMJJ_KlVxHaLy0Fs_caV", "192G4UkcNJO4EKN46ECujMcH0AQVhnyQe"),
}


def cache_home() -> str:
    return os.environ.get("R3M_HOME", os.path.join(expanduser("~"), ".r3m"))


def _parse_download_form(html: bytes):
    """Extract (action URL, hidden params) from Drive's modern large-file
    interstitial: a form targeting drive.usercontent.google.com/download
    with hidden ``id``/``export``/``confirm``/``uuid`` inputs (the flow
    current gdown implements; the cookie/inline-confirm dances below are
    the legacy variants)."""
    m = re.search(
        rb"<form[^>]*action=\"([^\"]+)\"[^>]*>(.*?)</form>", html, re.S
    )
    if not m:
        return None
    action, body = m.group(1).decode(), m.group(2)
    params = {
        k.decode(): v.decode()
        for k, v in re.findall(
            rb"<input[^>]*name=\"([^\"]+)\"[^>]*value=\"([^\"]*)\"", body
        )
    }
    if "confirm" not in params and "uuid" not in params:
        return None  # some other form (e.g. a search box), not the download
    return action, params


def _drive_download(file_id: str, dest: str) -> None:
    """Download a public Drive file (gdown-equivalent confirm-token flow)."""
    import requests

    url = "https://drive.google.com/uc"
    sess = requests.Session()
    resp = sess.get(url, params={"id": file_id, "export": "download"}, stream=True, timeout=60)
    resp.raise_for_status()
    token = None
    for k, v in resp.cookies.items():
        if k.startswith("download_warning"):
            token = v
    # Peek at most the first streamed chunk for the confirm marker — never
    # `resp.content`, which would buffer the whole artifact (hundreds of MB)
    # in RAM. If it isn't an interstitial, the peeked bytes ARE file data
    # and are written out first.
    first = b""
    if token is None:
        first = next(resp.iter_content(1 << 20), b"")
        if first.lstrip()[:1] == b"<":
            form = _parse_download_form(first)
            if form is not None:
                action, params = form
                params.setdefault("id", file_id)
                params.setdefault("export", "download")
                resp = sess.get(action, params=params, stream=True, timeout=60)
                resp.raise_for_status()
                first = b""
                token = None
            else:
                m = re.search(rb"confirm=([0-9A-Za-z_\-]+)", first)
                if m:
                    token = m.group(1).decode()
    if token is not None:
        resp = sess.get(
            url,
            params={"id": file_id, "export": "download", "confirm": token},
            stream=True,
            timeout=60,
        )
        resp.raise_for_status()
        first = b""
    tmp = dest + ".part"
    with open(tmp, "wb") as f:
        if first:
            f.write(first)
        for chunk in resp.iter_content(1 << 20):
            f.write(chunk)
    _validate_payload(tmp, dest)
    os.replace(tmp, dest)


def _validate_payload(tmp: str, dest: str) -> None:
    """Reject Drive interstitial/error pages BEFORE committing to the cache.

    Drive serves virus-scan/quota/removed pages as HTTP 200 HTML; writing
    one to ``model.pt`` would permanently poison the cache (ensure_artifacts
    sees the file exists and never re-downloads). ``model.pt`` must be a
    zip-container or legacy-pickle torch file; ``config.yaml`` must not be
    markup.
    """
    with open(tmp, "rb") as f:
        head = f.read(64)
    html = head.lstrip()[:1].lower() == b"<"
    if dest.endswith(".pt"):
        ok = head[:2] == b"PK" or head[:1] == b"\x80"
    else:
        ok = bool(head) and not html
    if not ok:
        os.remove(tmp)
        raise RuntimeError(
            f"Drive returned a non-artifact payload for {os.path.basename(dest)} "
            f"(starts with {head[:16]!r}) — likely a virus-scan/quota "
            "interstitial page. Retry later or download manually."
        )


def ensure_artifacts(modelid: str, reproduce: bool = False) -> Tuple[str, str]:
    """Return (model.pt path, config.yaml path), downloading if missing."""
    registry = REPRODUCE_REGISTRY if reproduce else MODEL_REGISTRY
    if modelid not in registry:
        raise NameError(f"Invalid Model ID: {modelid!r} (valid: {sorted(registry)})")
    folder, model_id, config_id = registry[modelid]
    home = os.path.join(cache_home(), folder)
    os.makedirs(home, exist_ok=True)
    modelpath = os.path.join(home, "model.pt")
    configpath = os.path.join(home, "config.yaml")
    if not os.path.exists(modelpath) or not os.path.exists(configpath):
        try:
            if not os.path.exists(modelpath):
                _drive_download(model_id, modelpath)
            if not os.path.exists(configpath):
                _drive_download(config_id, configpath)
        except Exception as e:
            raise RuntimeError(
                f"Pretrained artifacts for {modelid!r} are not cached at {home} "
                f"and could not be downloaded ({type(e).__name__}: {e}). "
                f"Copy model.pt + config.yaml there manually on offline hosts."
            ) from e
    return modelpath, configpath
