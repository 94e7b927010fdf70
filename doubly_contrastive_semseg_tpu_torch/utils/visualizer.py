"""Live-dashboard visualizer — port of the JAX package's
``utils/visualizer.py`` (reference ``utils/visualizer.py:4-83``).

The reference wraps a Visdom server with three calls — ``vis_scalar``
(append-to-line plot), ``vis_image``, ``vis_table`` (HTML key/value table) —
and is dead code there (never imported by the training path). Re-provided
here with the same method surface so downstream scripts that used it keep
working: Visdom is used when the package exists and a server answers;
otherwise every call degrades to local artifacts (``scalars.jsonl`` lines,
PNG dumps through PIL, ``tables.jsonl``) under ``log_dir``, the same files,
byte for byte, as JAX's — no network dependency on a headless host, nothing
to install.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


class Visualizer:
    """Drop-in for the reference ``Visualizer``: same ``vis_scalar`` /
    ``vis_image`` / ``vis_table`` methods and window-reuse semantics; backend
    is Visdom if reachable, else files under ``log_dir``."""

    def __init__(self, port: Any = "13579", env: str = "main",
                 id: Optional[str] = None, log_dir: str = "run_visualizer"):
        self.cur_win: Dict[str, Any] = {}
        self.id = id
        self.env = env
        self.log_dir = log_dir
        self.vis = None
        try:  # visdom is optional
            from visdom import Visdom  # type: ignore

            vis = Visdom(port=port, env=env, raise_exceptions=True)
            # restore window handles by title, as the reference does
            ori = json.loads(vis.get_window_data())
            self.cur_win = {v["title"]: k for k, v in ori.items()}
            self.vis = vis
        except Exception:
            os.makedirs(log_dir, exist_ok=True)

    def _name(self, name: str) -> str:
        return f"[{self.id}]{name}" if self.id is not None else name

    def _append(self, fname: str, record: Dict[str, Any]) -> None:
        record["ts"] = time.time()
        with open(os.path.join(self.log_dir, fname), "a") as f:
            f.write(json.dumps(record) + "\n")

    def vis_scalar(self, name: str, x, y, opts: Optional[dict] = None) -> None:
        xs = x if isinstance(x, list) else [x]
        ys = y if isinstance(y, list) else [y]
        name = self._name(name)
        if self.vis is not None:
            default_opts = {"title": name}
            if opts is not None:
                default_opts.update(opts)
            win = self.cur_win.get(name)
            if win is not None:
                self.vis.line(X=xs, Y=ys, opts=default_opts,
                              update="append", win=win)
            else:
                self.cur_win[name] = self.vis.line(X=xs, Y=ys,
                                                   opts=default_opts)
            return
        for xi, yi in zip(xs, ys):
            self._append("scalars.jsonl",
                         {"name": name, "x": float(xi), "y": float(yi)})

    def vis_image(self, name: str, img, env: Optional[str] = None,
                  opts: Optional[dict] = None) -> None:
        """``img`` is CHW or HWC uint8/float (the reference feeds CHW
        tensors); file fallback writes a PNG per call, window-named."""
        name = self._name(name)
        arr = np.asarray(img)
        if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
            chw = arr
        elif arr.ndim == 3:
            chw = np.moveaxis(arr, -1, 0)
        else:
            chw = arr[None]
        if self.vis is not None:
            default_opts = {"title": name}
            if opts is not None:
                default_opts.update(opts)
            win = self.cur_win.get(name)
            if win is not None:
                self.vis.image(img=chw, win=win, opts=opts,
                               env=env or self.env)
            else:
                self.cur_win[name] = self.vis.image(
                    img=chw, opts=default_opts, env=env or self.env)
            return
        from PIL import Image

        hwc = np.moveaxis(chw, 0, -1)
        if hwc.dtype != np.uint8:
            hwc = np.clip(hwc * (255.0 if hwc.max() <= 1.0 else 1.0),
                          0, 255).astype(np.uint8)
        if hwc.shape[-1] == 1:
            hwc = hwc[..., 0]
        safe = name.replace("/", "_").replace("[", "").replace("]", "_")
        step = self.cur_win.get(name, 0)
        self.cur_win[name] = step + 1
        Image.fromarray(hwc).save(
            os.path.join(self.log_dir, f"{safe}_{step:06d}.png"))

    def vis_table(self, name: str, tbl: Dict[str, Any],
                  opts: Optional[dict] = None) -> None:
        # unlike vis_scalar/vis_image, the reference's vis_table never
        # prefixes the id — keep window titles/keys on the same surface
        if self.vis is not None:
            rows = "".join(f"<tr><td>{k}</td><td>{v}</td></tr>"
                           for k, v in tbl.items())
            tbl_str = ("<table width=\"100%\"><tr><th>Term</th>"
                       f"<th>Value</th></tr>{rows}</table>")
            default_opts = {"title": name}
            if opts is not None:
                default_opts.update(opts)
            win = self.cur_win.get(name)
            if win is not None:
                self.vis.text(tbl_str, win=win, opts=default_opts)
            else:
                self.cur_win[name] = self.vis.text(tbl_str, opts=default_opts)
            return
        self._append("tables.jsonl", {"name": name, "table": dict(tbl)})
