"""Self-refreshing HTML gallery of training visuals: a copy of
``mdctgan_tpu/utils/html.py`` (the reference's ``util/html.py`` without its
``dominate`` dependency): ``web/index.html`` over ``web/images/``, newest
epochs first, with an auto-refresh meta tag."""

from __future__ import annotations

import html as _html
import os
from typing import List, Sequence, Tuple


class HTML:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.refresh = refresh
        os.makedirs(self.img_dir, exist_ok=True)
        # (header, [(image, caption), ...]) sections
        self._sections: List[Tuple[str, Sequence[Tuple[str, str]]]] = []

    def add_header(self, text: str) -> None:
        self._sections.append((text, []))

    def add_images(self, ims: Sequence[str], txts: Sequence[str], width: int = 512) -> None:
        if not self._sections:
            self.add_header("")
        header, imgs = self._sections[-1]
        self._sections[-1] = (header, list(imgs) + list(zip(ims, txts)))
        self._width = width

    def save(self) -> None:
        width = getattr(self, "_width", 512)
        parts = ["<!DOCTYPE html><html><head>"]
        parts.append(f"<title>{_html.escape(self.title)}</title>")
        if self.refresh:
            parts.append(f'<meta http-equiv="refresh" content="{self.refresh}">')
        parts.append(
            "<style>table{border-collapse:collapse}td{padding:4px;"
            "text-align:center;vertical-align:top}</style></head><body>"
        )
        for header, imgs in self._sections:
            parts.append(f"<h3>{_html.escape(header)}</h3>")
            if imgs:
                parts.append("<table><tr>")
                for im, _ in imgs:
                    parts.append(
                        f'<td><a href="images/{im}">'
                        f'<img src="images/{im}" width="{width}"></a></td>'
                    )
                parts.append("</tr><tr>")
                for _, txt in imgs:
                    parts.append(f"<td>{_html.escape(txt)}</td>")
                parts.append("</tr></table>")
        parts.append("</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "wt") as f:
            f.write("".join(parts))
