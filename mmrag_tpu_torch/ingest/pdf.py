"""PDF ingestion: page text -> char chunks, embedded images -> media files.

Contract mirrors the reference extractor (``app/ingest/
pdf.py:13-82``): per-page text runs through the 1200/200 char chunker, images
are written under ``MEDIA_DIR/pdf_images/{user}/{document}``, and the
function emits text/image node dicts ``{"id", "text"?, "image_path"?,
"metadata"}`` ready for the index builders.

Backends: PyMuPDF (``fitz``) when importable — the reference's engine — else
a built-in pure-Python parser (:class:`MiniPdf`) good enough for
non-encrypted PDFs with standard encodings: it walks the object graph, finds
``/Type /Page`` objects in order, inflates their content streams, extracts
text-showing operators (Tj/TJ/'/"), and pulls DCTDecode/FlateDecode image
XObjects. Host-side I/O only — no dense compute (SURVEY §2b keeps PDF
parsing on host).
"""

from __future__ import annotations

import logging
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

from ..settings import Settings, settings as _default_settings
from .chunk import chunk_text

logger = logging.getLogger(__name__)


class PdfExtractionError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Pure-Python fallback parser
# ---------------------------------------------------------------------------

_OBJ_RE = re.compile(rb"(\d+)\s+(\d+)\s+obj\b(.*?)endobj", re.DOTALL)
_STREAM_RE = re.compile(rb"stream\r?\n(.*?)\r?\nendstream", re.DOTALL)
_TEXT_OP_RE = re.compile(rb"\((?:\\.|[^\\()])*\)\s*(?:Tj|')|\[(?:[^\[\]]*)\]\s*TJ")
_STRING_RE = re.compile(rb"\((?:\\.|[^\\()])*\)")
_HEXSTR_RE = re.compile(rb"<([0-9A-Fa-f\s]+)>")


def _decode_pdf_string(raw: bytes) -> str:
    """Decode a PDF literal string body (between parens), handling escapes."""

    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == 0x5C and i + 1 < len(raw):  # backslash
            nxt = raw[i + 1]
            mapping = {
                ord("n"): 10, ord("r"): 13, ord("t"): 9, ord("b"): 8,
                ord("f"): 12, ord("("): 40, ord(")"): 41, ord("\\"): 92,
            }
            if nxt in mapping:
                out.append(mapping[nxt])
                i += 2
                continue
            if 0x30 <= nxt <= 0x37:  # octal escape, up to 3 digits
                j = i + 1
                oct_digits = b""
                while j < len(raw) and len(oct_digits) < 3 and 0x30 <= raw[j] <= 0x37:
                    oct_digits += bytes([raw[j]])
                    j += 1
                out.append(int(oct_digits, 8) & 0xFF)
                i = j
                continue
            i += 1  # line continuation or unknown escape
            continue
        out.append(c)
        i += 1
    # UTF-16BE BOM strings appear in metadata; page text is typically latin-ish
    if out[:2] == b"\xfe\xff":
        try:
            return out[2:].decode("utf-16-be", errors="ignore")
        except Exception:
            pass
    return out.decode("latin-1", errors="ignore")


class MiniPdf:
    """Minimal read-only PDF model: ordered pages + images."""

    def __init__(self, data: bytes) -> None:
        self.objects: Dict[int, bytes] = {}
        for m in _OBJ_RE.finditer(data):
            self.objects[int(m.group(1))] = m.group(3)

    def _stream(self, body: bytes) -> Optional[bytes]:
        m = _STREAM_RE.search(body)
        if not m:
            return None
        raw = m.group(1)
        if b"/FlateDecode" in body:
            try:
                return zlib.decompress(raw)
            except zlib.error:
                try:  # some writers pad the stream; try truncating garbage
                    return zlib.decompressobj().decompress(raw)
                except zlib.error:
                    return None
        return raw

    def _resolve_contents(self, body: bytes) -> List[int]:
        m = re.search(rb"/Contents\s*(\[(?:[^\]]*)\]|\d+\s+\d+\s*R)", body)
        if not m:
            return []
        return [int(n) for n in re.findall(rb"(\d+)\s+\d+\s*R", m.group(1))]

    def page_texts(self) -> List[str]:
        pages: List[Tuple[int, bytes]] = [
            (num, body)
            for num, body in sorted(self.objects.items())
            if re.search(rb"/Type\s*/Page\b(?!s)", body)
        ]
        texts = []
        for _, body in pages:
            content = b""
            for ref in self._resolve_contents(body):
                obj = self.objects.get(ref)
                if obj is None:
                    continue
                stream = self._stream(obj)
                if stream:
                    content += stream + b"\n"
            texts.append(self._extract_text(content))
        if not texts:  # last resort: every stream in the file
            blob = b"\n".join(
                s for s in (self._stream(b) for b in self.objects.values()) if s
            )
            text = self._extract_text(blob)
            if text:
                texts = [text]
        return texts

    @staticmethod
    def _extract_text(content: bytes) -> str:
        parts: List[str] = []
        token_re = re.compile(
            rb"\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]+>|-?\d+(?:\.\d+)?"
        )
        for op in _TEXT_OP_RE.finditer(content):
            blob = op.group(0)
            for tok in token_re.finditer(blob):
                t = tok.group(0)
                if t.startswith(b"("):
                    parts.append(_decode_pdf_string(t[1:-1]))
                elif t.startswith(b"<"):
                    raw = bytes.fromhex(re.sub(rb"\s", rb"", t[1:-1]).decode())
                    parts.append(raw.decode("latin-1", errors="ignore"))
                else:
                    # TJ kerning: a large negative adjustment (thousandths of
                    # an em) is how many writers encode inter-word spaces
                    try:
                        if float(t) <= -150:
                            parts.append(" ")
                    except ValueError:
                        pass
            parts.append(" ")
        text = "".join(parts)
        return re.sub(r"[ \t]+", " ", text).strip()

    def images(self) -> List[Tuple[str, bytes]]:
        """Returns (suggested_extension, bytes) per embedded image."""

        out = []
        for num, body in sorted(self.objects.items()):
            if b"/Subtype" not in body or b"/Image" not in body:
                continue
            m = _STREAM_RE.search(body)
            if not m:
                continue
            raw = m.group(1)
            if b"/DCTDecode" in body:
                out.append((".jpg", raw))
            elif b"/FlateDecode" in body:
                try:
                    pixels = zlib.decompress(raw)
                except zlib.error:
                    continue
                png = _flate_image_to_png(body, pixels)
                if png:
                    out.append((".png", png))
        return out


def _flate_image_to_png(body: bytes, pixels: bytes) -> Optional[bytes]:
    import io

    from PIL import Image

    def _int(key: bytes) -> Optional[int]:
        m = re.search(key + rb"\s+(\d+)", body)
        return int(m.group(1)) if m else None

    width, height = _int(rb"/Width"), _int(rb"/Height")
    bpc = _int(rb"/BitsPerComponent") or 8
    if not width or not height or bpc != 8:
        return None
    mode = "RGB" if b"/DeviceRGB" in body else "L"
    expected = width * height * (3 if mode == "RGB" else 1)
    if len(pixels) < expected:
        return None
    img = Image.frombytes(mode, (width, height), pixels[:expected])
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _extract_with_fitz(pdf_path: str):
    import fitz  # type: ignore

    doc = fitz.open(pdf_path)
    pages = [doc.load_page(i).get_text() for i in range(doc.page_count)]
    images: List[Tuple[str, bytes]] = []
    for i in range(doc.page_count):
        for xref, *_ in doc.load_page(i).get_images(full=True):
            info = doc.extract_image(xref)
            images.append((f".{info.get('ext', 'png')}", info["image"]))
    doc.close()
    return pages, images


def extract_pdf_nodes(
    user_id: str,
    document_id: str,
    pdf_path: str,
    cfg: Optional[Settings] = None,
) -> Tuple[List[Dict], List[Dict]]:
    """Returns (text_nodes, image_nodes) for the index builders."""

    cfg = cfg or _default_settings
    if not os.path.exists(pdf_path):
        raise PdfExtractionError(f"no such file: {pdf_path}")
    try:
        import fitz  # type: ignore  # noqa: F401

        pages, images = _extract_with_fitz(pdf_path)
    except ImportError:
        with open(pdf_path, "rb") as fh:
            data = fh.read()
        if not data.startswith(b"%PDF"):
            raise PdfExtractionError(f"not a PDF: {pdf_path}")
        pdf = MiniPdf(data)
        pages = pdf.page_texts()
        images = pdf.images()

    text_nodes: List[Dict] = []
    for page_no, text in enumerate(pages, start=1):
        for j, piece in enumerate(
            chunk_text(text, cfg.chunks.size_chars, cfg.chunks.overlap_chars)
        ):
            text_nodes.append(
                {
                    "id": f"{document_id}-p{page_no}-c{j}",
                    "text": piece,
                    "metadata": {"document_id": document_id, "page": page_no},
                }
            )

    image_dir = os.path.join(cfg.paths.media_dir, "pdf_images", user_id, document_id)
    image_nodes: List[Dict] = []
    if images:
        os.makedirs(image_dir, exist_ok=True)
    for k, (ext, blob) in enumerate(images):
        path = os.path.join(image_dir, f"img_{k}{ext}")
        with open(path, "wb") as fh:
            fh.write(blob)
        image_nodes.append(
            {
                "id": f"{document_id}-img{k}",
                "image_path": path,
                "metadata": {"document_id": document_id},
            }
        )
    logger.info(
        "pdf %s: %d pages -> %d text nodes, %d images",
        document_id, len(pages), len(text_nodes), len(image_nodes),
    )
    return text_nodes, image_nodes
