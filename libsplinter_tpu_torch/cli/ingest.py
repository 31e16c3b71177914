"""CLI `ingest` and `export`.

ingest: chunk a file/stdin into tandem VARTEXT slots sized to the store's
value capacity, label chunks/metadata, and bump per chunk so the
embedding daemon indexes as it goes — protocol parity with the reference
ingest command (SURVEY.md §2.3: labels 0x200 chunk / 0x400 meta, JSON
metadata slot, bump per chunk).

export: JSON dump of slot metadata sorted by epoch descending with
VARTEXT values inlined (reference export command).
"""
from __future__ import annotations

import json
import sys
import time

from .. import T_BIGUINT, T_JSON, T_VARTEXT
from ..engine import protocol as P
from .main import CliError, command


def chunk_text(text: str, size: int) -> list[str]:
    """Split on whitespace boundaries into <= size byte chunks.  A single
    token longer than size (base64 blobs, minified code) is hard-broken
    at the byte boundary so no chunk can ever exceed the store's value
    capacity."""
    words: list[str] = []
    for word in text.split():
        enc = word.encode()
        while len(enc) > size:
            words.append(enc[:size].decode(errors="ignore"))
            enc = enc[size:]
        if enc:
            words.append(enc.decode(errors="ignore"))
    chunks, cur, cur_len = [], [], 0
    for word in words:
        wl = len(word.encode()) + (1 if cur else 0)
        if cur_len + wl > size and cur:
            chunks.append(" ".join(cur))
            cur, cur_len = [], 0
            wl = len(word.encode())
        cur.append(word)
        cur_len += wl
    if cur:
        chunks.append(" ".join(cur))
    return chunks or [""]


@command("ingest", "ingest BASE [FILE|-] [--label MASK] [--no-embed]",
         "chunk a document into tandem VARTEXT slots + metadata")
def cmd_ingest(ses, args):
    if not args:
        raise CliError("usage: ingest BASE [FILE|-]")
    base = ses.key(args[0])
    src = args[1] if len(args) > 1 and not args[1].startswith("--") else "-"
    extra_label = 0
    if "--label" in args:
        extra_label = ses.label_mask(args[args.index("--label") + 1])
    embed = "--no-embed" not in args
    text = sys.stdin.read() if src == "-" else \
        open(src, encoding="utf-8", errors="replace").read()

    st = ses.store
    chunk_size = st.max_val - 64     # slop margin, like the reference
    chunks = chunk_text(text, chunk_size)

    for i, ch in enumerate(chunks):
        key = base if i == 0 else f"{base}.{i}"
        st.set(key, ch)
        st.set_type(key, T_VARTEXT)
        st.label_or(key, P.LBL_CHUNK | extra_label |
                    (P.LBL_EMBED_REQ if embed else 0))
        st.bump(key)                 # embedding daemon indexes as we go

    meta_key = f"{base}.meta"
    meta = {"source": src, "chunks": len(chunks),
            "bytes": len(text.encode()), "ingested_at": time.time()}
    st.set(meta_key, json.dumps(meta))
    st.set_type(meta_key, T_JSON)
    st.label_or(meta_key, P.LBL_META | extra_label)
    print(f"ingested {len(chunks)} chunks -> {base} (+{meta_key})")


@command("export", "export [REGEX] [--out FILE] [--values]",
         "JSON dump of all slots, newest epoch first (VARTEXT/JSON "
         "values inline; --values forces values for every type)")
def cmd_export(ses, args):
    """Logical store dump (reference: splinter_cli_cmd_export.c:47-141 —
    slot metadata sorted by epoch desc, VARTEXT values escaped inline)."""
    import re

    from pathlib import Path

    import numpy as np

    from .main import TYPE_NAMES

    rx, out_path, with_values = None, None, "--values" in args
    rest, it = [], iter(args)
    for a in it:
        if a == "--out":
            out_path = next(it, None)
            if out_path is None:
                raise CliError("--out needs a file argument")
        elif a == "--regex":
            pat = next(it, None)
            if pat is None:
                raise CliError("--regex needs a pattern argument")
            rx = re.compile(pat)
        elif not a.startswith("--"):
            rest.append(a)
    if rest and rx is None:
        rx = re.compile(rest[0])
    st = ses.store
    slots = []
    for key in st.list():
        if rx and not rx.search(key):
            continue
        try:
            s = st.slot(key)
        except (KeyError, OSError):
            continue  # key unset by a concurrent writer since list()
        rec = {
            "key": s.key, "index": s.index, "epoch": s.epoch,
            "type": TYPE_NAMES.get(s.type, hex(s.type)),
            "val_len": s.val_len, "labels": f"{s.labels:#x}",
            "ctime": s.ctime, "atime": s.atime,
        }
        try:
            if s.type == T_BIGUINT:
                rec["value"] = st.get_uint(key)
            elif s.type in (T_VARTEXT, T_JSON) or with_values:
                rec["value"] = st.get_str(key)
        except (KeyError, OSError, ValueError):
            pass
        if st.vec_dim:
            mag = float(np.linalg.norm(st.vec_get_at(s.index)))
            if mag > 0:
                rec["vec_magnitude"] = round(mag, 6)
        slots.append(rec)
    slots.sort(key=lambda r: -r["epoch"])
    h = st.header()
    payload = json.dumps({
        "store": ses.store_name, "nslots": st.nslots,
        "max_val": st.max_val, "vec_dim": st.vec_dim,
        "global_epoch": h.global_epoch, "count": len(slots),
        "slots": slots,
    }, indent=2)
    if out_path:
        Path(out_path).write_text(payload + "\n")
        print(f"exported {len(slots)} slots to {out_path}")
    else:
        print(payload)
