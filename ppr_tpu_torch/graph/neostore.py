"""Read-only parser for the Neo4j 3.5 "standard" binary record store —
a copy of ``ppr_tpu/graph/neostore.py`` (numpy only, host-side), whose
:func:`load_neo4j_store` places the graph on a device.

The reference opens its embedded database directly (``createDb``,
PPR.java:52-60, on ``target/got.db``) and loads the graph from it through
the graph-algorithms ``HeavyGraphFactory`` (PPR.java:141-147). This module
reads the binary store itself — no JVM, no Neo4j, just the fixed-size
record formats of the 3.5 "standard" store family, parsed with numpy:

* ``neostore.nodestore.db``          — 15-byte node records
* ``neostore.relationshipstore.db``  — 34-byte relationship records
* ``neostore.propertystore.db``      —  41-byte property records
  (4x 8-byte big-endian property blocks; inline "LongerShortString"
  values, or a dynamic-store pointer for long strings)
* ``neostore.propertystore.db.index``/``.keys`` — property-key tokens
* ``neostore.propertystore.db.strings`` — dynamic string store

Record layouts follow the open-source Neo4j 3.5 record-format classes
(NodeRecordFormat / RelationshipRecordFormat / PropertyRecordFormat /
LongerShortString). ``tests/test_torch_neostore.py`` writes a small store
in these layouts and holds this reader to the JAX package's on it.

High-order id bits (>32-bit node/rel/prop ids) are parsed per the format
spec but exercised only as zeros here.
"""

from __future__ import annotations

import os

import numpy as np

NODE_RECORD = 15
REL_RECORD = 34
PROP_RECORD = 41
#: TokenStore.NAME_STORE_BLOCK_SIZE(30) + 8-byte dynamic header
KEY_NAME_RECORD = 38
#: PropertyStore string block: 120 data bytes + 8-byte header
STRING_RECORD = 128

_NO_ID = 0xFFFFFFFF


def _records(path: str, size: int) -> np.ndarray:
    """Load a fixed-record-size store file as a [n_records, size] u8 array."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = raw.size // size
    return raw[: n * size].reshape(n, size)


def _be32(rec: np.ndarray, off: int) -> np.ndarray:
    """Big-endian u32 column at byte offset ``off`` of each record."""
    return (
        (rec[:, off].astype(np.int64) << 24)
        | (rec[:, off + 1].astype(np.int64) << 16)
        | (rec[:, off + 2].astype(np.int64) << 8)
        | rec[:, off + 3].astype(np.int64)
    )


# ----------------------------------------------------------------- stores
def read_nodes(db_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """In-use node internal ids and their first-property ids.

    NodeRecordFormat (15B): ``[inUse|relHigh|propHigh][nextRel 4B]
    [nextProp 4B][labels 5B][extra 1B]``; byte0 bits 1-3 extend nextRel,
    bits 4-7 extend nextProp.
    """
    rec = _records(os.path.join(db_dir, "neostore.nodestore.db"), NODE_RECORD)
    in_use = (rec[:, 0] & 1).astype(bool)
    next_prop = _be32(rec, 5) | (((rec[:, 0].astype(np.int64) >> 4) & 0xF) << 32)
    ids = np.nonzero(in_use)[0].astype(np.int64)
    return ids, next_prop[in_use]


def read_relationships(db_dir: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, dst, type) of every in-use relationship record.

    RelationshipRecordFormat (34B): ``[inUse|firstHigh|propHigh]
    [firstNode 4B][secondNode 4B][typeWord 4B][firstPrev 4B][firstNext 4B]
    [secondPrev 4B][secondNext 4B][nextProp 4B][flags 1B]``; the type word
    packs secondNode's high bits in its top nibble and the type id in its
    low 16 bits.
    """
    rec = _records(
        os.path.join(db_dir, "neostore.relationshipstore.db"), REL_RECORD
    )
    in_use = (rec[:, 0] & 1).astype(bool)
    first = _be32(rec, 1) | (((rec[:, 0].astype(np.int64) >> 1) & 0x7) << 32)
    type_word = _be32(rec, 9)
    second = _be32(rec, 5) | (((type_word >> 28) & 0x7) << 32)
    rtype = type_word & 0xFFFF
    return first[in_use], second[in_use], rtype[in_use]


def _read_tokens(idx_path: str, names_path: str, record_size: int,
                 name_id_off: int) -> dict[int, str]:
    idx = _records(idx_path, record_size)
    names = _records(names_path, KEY_NAME_RECORD)
    out: dict[int, str] = {}
    for tid in np.nonzero((idx[:, 0] & 1).astype(bool))[0]:
        name_id = int(_be32(idx[tid : tid + 1], name_id_off)[0])
        out[int(tid)] = _read_dynamic(names, name_id).decode("utf-8")
    return out


def read_property_key_tokens(db_dir: str) -> dict[int, str]:
    """Property-key token id -> key name (e.g. {0: "name"}).

    Token records (9B): ``[inUse][propCount 4B][nameId 4B]``; names live in
    the ``.keys`` dynamic store (38B records: 8B header + 30B data).
    """
    return _read_tokens(
        os.path.join(db_dir, "neostore.propertystore.db.index"),
        os.path.join(db_dir, "neostore.propertystore.db.index.keys"),
        9, 5,
    )


def read_relationship_type_tokens(db_dir: str) -> dict[int, str]:
    """Relationship-type token id -> name (e.g. {0: "Relation"}).

    Token records (5B): ``[inUse][nameId 4B]``. Backs the reference's
    ``--rel`` flag (PPR.java:126, relationship type filter).
    """
    return _read_tokens(
        os.path.join(db_dir, "neostore.relationshiptypestore.db"),
        os.path.join(db_dir, "neostore.relationshiptypestore.db.names"),
        5, 1,
    )


def read_label_tokens(db_dir: str) -> dict[int, str]:
    """Label token id -> name. Same 5B token record as relationship types.

    Note: got.db carries the "Person" label *token* (created by the
    reference's schema/index setup, PPR.java:70-119) but its import CSVs
    have no ``:LABEL`` column, so the node records themselves are
    unlabeled and the ``--label Person`` flag is vacuous there; the
    tokens are exposed for stores that do label their nodes.
    """
    return _read_tokens(
        os.path.join(db_dir, "neostore.labeltokenstore.db"),
        os.path.join(db_dir, "neostore.labeltokenstore.db.names"),
        5, 1,
    )


def _read_dynamic(rec: np.ndarray, start_id: int) -> bytes:
    """Follow a dynamic-store record chain; return the concatenated data.

    Dynamic record: ``[flags|lenHigh][len 3B total incl. byte0 low nibble]
    [nextBlock 4B][data ...]`` — in the 3.5 format the used-byte count is
    the low 24 bits of the first word and the next-block id the second.
    """
    out = bytearray()
    rid = start_id
    for _ in range(1 << 20):  # chain-length guard
        if rid == _NO_ID or rid >= rec.shape[0]:
            break
        r = rec[rid]
        nbytes = (int(r[1]) << 16) | (int(r[2]) << 8) | int(r[3])
        nxt = int(_be32(rec[rid : rid + 1], 4)[0])
        out += bytes(r[8 : 8 + nbytes])
        if nxt == _NO_ID:
            break
        rid = nxt
    return bytes(out)


# ------------------------------------------------- short-string decoding
# LongerShortString encodings: (encoding id, bits per char). Decode tables
# follow the Neo4j 3.5 class of the same name; ALPHANUM/ALPHASYM delegate
# to EUROPEAN shifted by 0x40, exactly as upstream does.
_PUNCTUATION = " _.-:/ .-+,'@|;*?&%#()$<>="


def _dec_punct(code: int) -> str:
    return _PUNCTUATION[code] if 0 <= code < len(_PUNCTUATION) else "�"


def _dec_european(code: int) -> str:
    if code < 0x40:
        if code == 0x17:
            return "."
        if code == 0x37:
            return "-"
        return chr(code + 0xC0)  # Latin-1 accented block
    if code == 0x40:
        return " "
    if code == 0x60:
        return "_"
    if 0x5B <= code < 0x60:
        return chr(ord("0") + code - 0x5B)  # digits 0-4
    if code >= 0x7B:
        return chr(ord("5") + code - 0x7B)  # digits 5-9
    return chr(code)  # A-Z at 0x41-0x5A, a-z at 0x61-0x7A


def _dec_char(enc: int, c: int) -> str:
    if enc == 1:  # NUMERICAL
        return chr(ord("0") + c) if c < 10 else _dec_punct(c - 10 + 6)
    if enc == 2:  # DATE
        return chr(ord("0") + c) if c < 10 else _dec_punct(c - 10)
    if enc == 3:  # UPPER
        return " " if c == 0 else (
            chr(ord("A") + c - 1) if c <= 0x1A else _dec_punct(c - 0x1A)
        )
    if enc == 4:  # LOWER
        return " " if c == 0 else (
            chr(ord("a") + c - 1) if c <= 0x1A else _dec_punct(c - 0x1A)
        )
    if enc == 5:  # EMAIL
        return "@" if c == 0 else (
            chr(ord("a") + c - 1) if c <= 0x1A else _dec_punct(c - 0x1A + 6)
        )
    if enc in (6, 7, 8):  # URI / ALPHANUM / ALPHASYM -> EUROPEAN + 0x40
        return _dec_european(c + 0x40)
    if enc == 9:  # EUROPEAN
        return _dec_european(c)
    if enc == 10:  # LATIN1
        return chr(c)
    return "�"


_BITS_PER_CHAR = {1: 4, 2: 4, 3: 5, 4: 5, 5: 5, 6: 6, 7: 6, 8: 7, 9: 9, 10: 8}


class _BitStream:
    """LSB-first bit reader over consecutive big-endian 8-byte blocks —
    the layout neo4j's ``Bits`` writer produces for property payloads
    (verified bit-exact on got.db: char 4 of "Aemon" straddles blocks)."""

    def __init__(self, blocks: list[int], start_bit: int):
        self.blocks = blocks
        self.pos = start_bit

    def take(self, nbits: int) -> int:
        v = 0
        for j in range(nbits):
            b, o = divmod(self.pos + j, 64)
            v |= ((self.blocks[b] >> o) & 1) << j
        self.pos += nbits
        return v


def _decode_short_string(blocks: list[int]) -> str:
    """Inline SHORT_STRING value: header ``[key 24][type 4][enc 5][len 6]``
    then ``len`` characters of ``bits_per_char(enc)`` bits each."""
    first = blocks[0]
    enc = (first >> 28) & 0x1F
    length = (first >> 33) & 0x3F
    if enc == 0:  # UTF8: raw bytes in the same bit stream
        bs = _BitStream(blocks, 39)
        return bytes(bs.take(8) for _ in range(length)).decode(
            "utf-8", errors="replace"
        )
    bpc = _BITS_PER_CHAR.get(enc)
    if bpc is None:
        return "�" * length
    bs = _BitStream(blocks, 39)
    return "".join(_dec_char(enc, bs.take(bpc)) for _ in range(length))


def _short_string_span(blocks: list[int]) -> int:
    first = blocks[0]
    enc = (first >> 28) & 0x1F
    length = (first >> 33) & 0x3F
    bpc = 8 if enc == 0 else _BITS_PER_CHAR.get(enc, 8)
    return max(1, -(-(39 + length * bpc) // 64))


# property value type ids (PropertyType)
_T_BOOL, _T_BYTE, _T_SHORT, _T_CHAR, _T_INT = 1, 2, 3, 4, 5
_T_LONG, _T_FLOAT, _T_DOUBLE, _T_STRING, _T_ARRAY = 6, 7, 8, 9, 10
_T_SHORT_STRING, _T_SHORT_ARRAY = 11, 12


def _block_span(blocks: list[int]) -> int:
    """How many 8-byte blocks the property starting at ``blocks[0]`` uses."""
    t = (blocks[0] >> 24) & 0xF
    if t == _T_DOUBLE:
        return 2
    if t == _T_LONG:
        return 1 if (blocks[0] >> 28) & 1 else 2  # inline-value flag
    if t == _T_SHORT_STRING:
        return _short_string_span(blocks)
    if t == _T_SHORT_ARRAY:
        # header [key 24][type 4][arrayType 4][len ...]: conservatively a
        # full record; short arrays are not used by any PPR surface
        return 4
    return 1


def read_string_properties(
    db_dir: str, first_prop: np.ndarray, key: str = "name"
) -> list[str | None]:
    """The ``key`` string property for each entity's property chain head.

    Walks PropertyRecordFormat chains (41B records: ``[prev/next high
    nibbles][prevProp 4B][nextProp 4B][4x 8B blocks]``), decoding inline
    short strings and following dynamic-store pointers (STRING type) into
    ``propertystore.db.strings``. Mirrors what ``getNodeName`` reads via a
    Neo4j transaction (Algo_Util.java:21-30).
    """
    props = _records(
        os.path.join(db_dir, "neostore.propertystore.db"), PROP_RECORD
    )
    strings_path = os.path.join(db_dir, "neostore.propertystore.db.strings")
    strings = (
        _records(strings_path, STRING_RECORD)
        if os.path.exists(strings_path)
        else np.zeros((0, STRING_RECORD), np.uint8)
    )
    tokens = read_property_key_tokens(db_dir)
    key_ids = {tid for tid, nm in tokens.items() if nm == key}

    # pre-split every record's payload into 4 big-endian u64 blocks
    payload = props[:, 9:].reshape(-1, 4, 8).astype(np.uint64)
    shifts = np.uint64(8) * np.arange(7, -1, -1, dtype=np.uint64)
    blocks_all = (payload << shifts).sum(axis=2, dtype=np.uint64)
    next_prop = _be32(props, 5) | (
        (props[:, 0].astype(np.int64) & 0xF) << 32
    )

    out: list[str | None] = []
    for head in first_prop:
        rid = int(head)
        val: str | None = None
        for _ in range(1 << 12):  # chain guard
            if rid == _NO_ID or rid >= props.shape[0] or val is not None:
                break
            blocks = [int(b) for b in blocks_all[rid]]
            i = 0
            while i < 4:
                b0 = blocks[i]
                t = (b0 >> 24) & 0xF
                if t == 0:
                    break  # rest of record unused
                if (b0 & 0xFFFFFF) in key_ids:
                    if t == _T_SHORT_STRING:
                        val = _decode_short_string(blocks[i:])
                    elif t == _T_STRING:
                        dyn_id = (b0 >> 28) & 0xFFFFFFFFF
                        val = _read_dynamic(strings, int(dyn_id)).decode(
                            "utf-8", errors="replace"
                        )
                    break
                i += _block_span(blocks[i:])
            if val is not None:
                break
            rid = int(next_prop[rid])
        out.append(val)
    return out


# ------------------------------------------------------------ public API
def is_neo4j_store(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "neostore.nodestore.db")
    )


def load_neo4j_store(
    db_dir: str,
    *,
    name: str | None = None,
    name_property: str = "name",
    rel_type: str | None = None,
    dense_threshold: int = 4096,
    device=None,
):
    """Load a Neo4j 3.5 store directory as a :class:`~..graph.io.Dataset`.

    The dense 0..n-1 id mapping follows ascending internal node id — the
    same order the reference's HeavyGraphFactory assigns mapped ids
    (PPR.java:141-147), which for an imported store is input order, so the
    result is graph-identical to loading the import CSVs. ``rel_type``
    keeps only relationships of that type (the ``--rel`` flag,
    PPR.java:126); label filtering is not applied — the reference's own
    import CSVs carry no ``:LABEL`` column, so got.db's nodes are
    unlabeled and PPR.java:124's ``--label Person`` is vacuous there.
    ``device`` is the graph's (default: the card).
    """
    from .csr import build_graph
    from .io import Dataset

    node_ids, first_prop = read_nodes(db_dir)
    src_raw, dst_raw, rtype = read_relationships(db_dir)
    if rel_type is not None:
        tokens = read_relationship_type_tokens(db_dir)
        wanted = {tid for tid, nm in tokens.items() if nm == rel_type}
        if not wanted:
            raise ValueError(
                f"{db_dir}: no relationship type {rel_type!r}; "
                f"store has {sorted(tokens.values())}"
            )
        keep = np.isin(rtype, list(wanted))
        src_raw, dst_raw = src_raw[keep], dst_raw[keep]

    lookup = np.full(int(node_ids.max()) + 2 if node_ids.size else 1, -1,
                     np.int64)
    lookup[node_ids] = np.arange(node_ids.size)
    src = lookup[src_raw]
    dst = lookup[dst_raw]
    if (src < 0).any() or (dst < 0).any():
        raise ValueError(f"{db_dir}: relationship endpoints reference "
                         "deleted/unused node records")

    names_raw = read_string_properties(db_dir, first_prop, key=name_property)
    names = [
        nm if nm is not None else str(int(nid))
        for nm, nid in zip(names_raw, node_ids)
    ]

    graph = build_graph(src, dst, n=node_ids.size,
                        dense_threshold=dense_threshold, device=device)
    if name is None:
        name = os.path.basename(os.path.normpath(db_dir)).removesuffix(".db")
    return Dataset(graph=graph, names=names, name=name)
