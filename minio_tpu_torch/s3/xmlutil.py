"""Minimal XML building/parsing for the S3 wire format (ref
cmd/api-response.go XML marshaling).

The port's own copy of ``minio_tpu/s3/xmlutil.py``, with no change in
behaviour."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

S3_XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"


class Element:
    """Tiny ordered XML builder."""

    def __init__(self, tag: str, xmlns: str = ""):
        self.tag = tag
        self.xmlns = xmlns
        self.children: list["Element | tuple[str, str]"] = []

    def child(self, tag: str, text: str | int | bool | None = None,
              ) -> "Element":
        if text is None:
            e = Element(tag)
            self.children.append(e)
            return e
        if isinstance(text, bool):
            text = "true" if text else "false"
        self.children.append((tag, str(text)))
        return self

    def append(self, e: "Element") -> "Element":
        self.children.append(e)
        return e

    def _render(self, out: list[str]) -> None:
        attrs = f' xmlns="{self.xmlns}"' if self.xmlns else ""
        out.append(f"<{self.tag}{attrs}>")
        for c in self.children:
            if isinstance(c, Element):
                c._render(out)
            else:
                tag, text = c
                out.append(f"<{tag}>{escape(text)}</{tag}>")
        out.append(f"</{self.tag}>")

    def tobytes(self) -> bytes:
        out: list[str] = ['<?xml version="1.0" encoding="UTF-8"?>']
        self._render(out)
        return "".join(out).encode("utf-8")


def parse(data: bytes) -> ET.Element:
    """Parse a request XML body; strips namespaces for easy lookup."""
    root = ET.fromstring(data)
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return root
