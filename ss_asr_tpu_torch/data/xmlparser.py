"""TEI-namespace XML -> plain text for LM corpora (Risamálheild).

Copied from ``ss_asr_tpu/data/xmlparser.py`` (standard library only): each ``<s>`` sentence is flattened
with spaces before ``<w>`` word tokens (but not before punctuation tokens),
one document per output line; ``prepro_file`` re-normalizes an existing text
file line by line.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

from ss_asr_tpu_torch.vocab import normalize_string

TEI_NS = "{http://www.tei-c.org/ns/1.0}"


def _flatten_sentence(sentence) -> str:
    """Join a TEI ``<s>`` element's tokens into running text.

    Word tokens (``<w>``) get a separating space; anything else (``<c>``
    punctuation) attaches directly to the preceding token, so
    ``[w:halló, c:,, w:heimur]`` becomes ``"halló, heimur"``.
    """
    parts = []
    for token in sentence:
        if token.text is None:
            # empty (<w/>) or nested-markup tokens carry no direct text;
            # the reference would render the literal string 'None' here
            # (str(None)), poisoning the corpus — skip them instead
            continue
        needs_space = parts and token.tag == TEI_NS + "w"
        parts.append((" " if needs_space else "") + token.text)
    return "".join(parts)


def parse_document(file_path: str) -> str:
    root = ET.parse(str(file_path)).getroot()
    return " ".join(
        _flatten_sentence(s) for s in root.iter(TEI_NS + "s")
    )


def parse(parent_dir: str, out_path: str, reset_file: bool = False) -> int:
    """Walk **/*.xml under parent_dir, append one line per document."""
    n = 0
    with open(out_path, "w" if reset_file else "a", encoding="utf-8") as out_file:
        for file_path in Path(parent_dir).glob("**/*.xml"):
            out_file.write(parse_document(str(file_path)) + "\n")
            n += 1
    return n


def prepro_file(in_file: str, out_file: str) -> None:
    """Normalize every line of a text file into the closed char inventory."""
    with open(out_file, "w", encoding="utf-8") as o, open(in_file, "r", encoding="utf-8") as i:
        for line in i:
            # normalization collapses the trailing \n into a space — restore
            # the line structure (one record per line) explicitly. The
            # reference (src/xmlparser.py:12-14) loses it, merging the whole
            # corpus into one line; fixed deliberately.
            o.write(normalize_string(line, append_tokens=False)[0].rstrip() + "\n")
