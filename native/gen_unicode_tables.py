"""Generate unicode_tables.inc for the native UTF-8 tokenizer.

The native tokenizer must produce byte-identical tokens to the Python
segmentation analyzer (analyzers.py: the word class of
analysis/word_chars.py, str.isalpha / isdigit, str.lower/upper). Rather
than re-deriving Unicode semantics in C++, the tables are generated FROM
the same data and Python runtime at build time (Makefile rule), so the
two paths agree by construction.

Flags per code point:
  1  WORD   — in analysis/word_chars.py's WORD_RANGES (token character)
  2  ALPHA  — str.isalpha
  4  DIGIT  — str.isdigit
  8  CASE_COMPLEX — lower()/upper() is multi-char or context-sensitive
                    (sigma final form); the tokenizer falls back to
                    Python for texts containing these
Case deltas (lower/upper) are simple single-char mappings.
"""

import importlib.util
import os
import sys

NCP = 0x110000
BLOCK = 256


def _word_chars():
    """analysis/word_chars.py, loaded by path: the table needs neither the
    package's imports nor any third-party module."""
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir,
        "iresearch_tpu", "analysis", "word_chars.py",
    )
    spec = importlib.util.spec_from_file_location("word_chars", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    is_word = _word_chars().is_word
    flags = bytearray(NCP)
    lower = [0] * NCP
    upper = [0] * NCP
    for cp in range(NCP):
        if 0xD800 <= cp <= 0xDFFF:
            continue  # surrogates: invalid in UTF-8, decoder rejects
        ch = chr(cp)
        f = 0
        if is_word(cp):
            f |= 1
        if ch.isalpha():
            f |= 2
        if ch.isdigit():
            f |= 4
        lo = ch.lower()
        up = ch.upper()
        complex_case = len(lo) != 1 or len(up) != 1 or cp == 0x03A3
        if complex_case:
            f |= 8
        else:
            lower[cp] = ord(lo) - cp
            upper[cp] = ord(up) - cp
        flags[cp] = f

    out = sys.stdout
    out.write("// generated by gen_unicode_tables.py — DO NOT EDIT\n")

    def emit(name, ctype, values, fmt):
        blocks = {}
        index = []
        for b in range(NCP // BLOCK):
            blk = tuple(values[b * BLOCK : (b + 1) * BLOCK])
            bid = blocks.setdefault(blk, len(blocks))
            index.append(bid)
        ordered = sorted(blocks, key=blocks.get)
        out.write(
            f"static const {ctype} {name}_data[{len(ordered)}][{BLOCK}] = {{\n"
        )
        for blk in ordered:
            out.write("{" + ",".join(fmt % v for v in blk) + "},\n")
        out.write("};\n")
        out.write(
            f"static const unsigned short {name}_index[{len(index)}] = {{"
            + ",".join(str(i) for i in index)
            + "};\n"
        )

    emit("u_flag", "unsigned char", flags, "%d")
    emit("u_lower", "int", lower, "%d")
    emit("u_upper", "int", upper, "%d")


if __name__ == "__main__":
    main()
