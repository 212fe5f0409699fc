"""Training-curve plots (lib/funcs_utils.py:131-151 equivalent).

`save_plot` writes a loss or error curve as a one-page PDF into
<output_dir>/graph, as the reference's save_plot does.  The PDF is written
with the standard library alone (an axis box with its value range, the
polyline with a marker per epoch, the title and the axis labels), so the
trainer needs no plotting package on any machine.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional, Sequence

__all__ = ["save_plot"]

PAGE_W, PAGE_H = 460.8, 345.6  # points: a 6.4 x 4.8 inch figure
BOX = (64.0, 48.0, 372.0, 250.0)  # axis box: left, bottom, width, height


def _text(s: str) -> str:
    return s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def _label(x: float, y: float, s: str, size: int = 9) -> str:
    return f"BT /F1 {size} Tf {x:.2f} {y:.2f} Td ({_text(s)}) Tj ET"


def _pdf_page(content: str) -> bytes:
    """A one-page PDF of PAGE_W x PAGE_H points drawing `content` (a PDF
    content stream; font /F1 is Helvetica)."""
    stream = content.encode("latin-1", "replace")
    objects = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {PAGE_W} {PAGE_H}] "
         f"/Contents 4 0 R /Resources << /Font << /F1 5 0 R >> >> >>").encode(),
        b"<< /Length %d >>\nstream\n" % len(stream) + stream + b"\nendstream",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
    ]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objects, 1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objects) + 1)
    for off in offsets:
        out += b"%010d 00000 n \n" % off
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objects) + 1, xref))
    return bytes(out)


def _curve(values: List[float], title: str, ylabel: str) -> str:
    left, bottom, width, height = BOX
    n = len(values)
    lo, hi = (min(values), max(values)) if values else (0.0, 1.0)
    if hi - lo <= 1e-12 * max(1.0, abs(hi)):
        lo, hi = lo - max(1.0, abs(lo)) * 0.05, hi + max(1.0, abs(hi)) * 0.05

    def px(i: int) -> float:
        return left + (width * 0.5 if n == 1 else width * i / (n - 1))

    def py(v: float) -> float:
        return bottom + height * (0.05 + 0.9 * (v - lo) / (hi - lo))

    ops = ["0.5 w 0 0 0 RG", f"{left} {bottom} {width} {height} re S"]
    if values:
        pts = [(px(i), py(v)) for i, v in enumerate(values)]
        ops.append("1.5 w 0.12 0.47 0.71 RG 0.12 0.47 0.71 rg")
        ops.append(" ".join(f"{x:.2f} {y:.2f} {'m' if i == 0 else 'l'}"
                            for i, (x, y) in enumerate(pts)) + " S")
        ops += [f"{x - 2.5:.2f} {y - 2.5:.2f} 5 5 re f" for x, y in pts]
    ops.append("0 g")
    ops.append(_label(left, bottom + height + 10, title, 12))
    ops.append(_label(left + width * 0.5 - 12, 18, "epoch"))
    ops.append(_label(8, bottom + height + 10 - 24, ylabel))
    ops.append(_label(8, py(hi) - 3, f"{hi:.4g}"))
    ops.append(_label(8, py(lo) - 3, f"{lo:.4g}"))
    ops.append(_label(px(0) - 2, bottom - 14, "1"))
    if n > 1:
        ops.append(_label(px(n - 1) - 4, bottom - 14, str(n)))
    return "\n".join(ops)


def save_plot(values: Sequence[float], out_dir: str, *,
              title: str = "loss", ylabel: str = "loss",
              epoch: Optional[int] = None) -> str:
    """Write `values` (one per epoch) as <out_dir>/<title>[_<epoch>].pdf."""
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{epoch}" if epoch is not None else ""
    path = osp.join(out_dir, f"{title}{suffix}.pdf")
    with open(path, "wb") as f:
        f.write(_pdf_page(_curve([float(v) for v in values], title, ylabel)))
    return path
