"""The port's Neo4j 3.5 store reader (``ppr_tpu_torch/graph/neostore.py``)
against the JAX package's (``ppr_tpu/graph/neostore.py``), on a store that
this file writes.

The reference's own store (``target/got.db``) is not in the repository, so
:func:`write_store` writes a small one in the record layouts the reader
parses: node, relationship and property records, the property-key,
relationship-type and label token stores with their dynamic name stores,
and the dynamic string store. Node names are stored as inline short strings
in every encoding the reader decodes (UTF-8, numerical, date, upper, lower,
e-mail, URI, alphanumeric, alphanumeric-symbol, European, Latin-1), some
behind another property or in a chained property record, and one long
name in the dynamic string store. The store also holds a deleted node, a
deleted relationship, a node without properties and relationships of a
second type.

``write_store`` imports nothing of JAX or the JAX package: ``chip_smoke.py``
writes its ``[neostore]`` store with it. The JAX package is imported inside
the tests that compare with it.

Held exactly: the graph's fields, the names, the tokens, the short-string
decoder on the unit cases of ``tests/test_neostore.py``, and the CLI's
dispatch.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

#: the encodings of LongerShortString the reader decodes, with their bits a
#: character (``neostore._BITS_PER_CHAR``; UTF-8 is 8 a byte)
ENCODINGS = {0: 8, 1: 4, 2: 4, 3: 5, 4: 5, 5: 5, 6: 6, 7: 6, 8: 7, 9: 9,
             10: 8}
_NO_ID = 0xFFFFFFFF
_SHORT_STRING, _STRING, _INT, _DOUBLE = 11, 9, 5, 8


def _letters(i: int, base: str) -> str:
    """``i`` written in the letters of ``base`` (a unique suffix)."""
    out = base[i % len(base)]
    i //= len(base)
    while i:
        out += base[i % len(base)]
        i //= len(base)
    return out


def sample_name(i: int) -> tuple[str, int]:
    """Node ``i``'s name and the encoding it is stored in."""
    enc = i % len(ENCODINGS)
    lower = _letters(i, "abcdefghijklmnopqrstuvwxyz")
    return {
        0: (f"Żółw {i}", 0),
        1: (f"{1000 + i}.5", 1),
        2: (f"2024-01-{i:02d}", 2),
        3: (f"NODE {lower.upper()}", 3),
        4: (f"node {lower}", 4),
        5: (f"{lower}@graph", 5),
        6: (f"Uri_{i}", 6),
        7: (f"Person {i}", 7),
        8: (f"Sym_{i} x", 8),
        9: (f"Ærø {lower}", 9),
        10: (f"Café {i}", 10),
    }[enc]


def _decoder_table(enc: int) -> dict[str, int]:
    """Character -> code of one encoding, inverted from the port's decode
    table (the first code that decodes to a character wins)."""
    from ppr_tpu_torch.graph.neostore import _dec_char

    table: dict[str, int] = {}
    for code in range(1 << ENCODINGS[enc]):
        table.setdefault(_dec_char(enc, code), code)
    return table


def _codes(name: str, enc: int) -> list[int]:
    if enc == 0:
        return list(name.encode("utf-8"))
    table = _decoder_table(enc)
    missing = [c for c in name if c not in table]
    if missing:
        raise ValueError(f"{name!r} does not fit encoding {enc}: {missing}")
    return [table[c] for c in name]


def _put(blocks: list[int], value: int, nbits: int, pos: int) -> int:
    """Write ``value``'s ``nbits`` low bits LSB-first at bit ``pos`` of the
    stream of 64-bit blocks."""
    for j in range(nbits):
        b, o = divmod(pos + j, 64)
        while len(blocks) <= b:
            blocks.append(0)
        blocks[b] |= ((value >> j) & 1) << o
    return pos + nbits


def short_string_blocks(key: int, name: str, enc: int) -> list[int]:
    """An inline SHORT_STRING property: ``[key 24][type 4][enc 5][len
    6]``, then the characters."""
    codes = _codes(name, enc)
    blocks: list[int] = []
    pos = _put(blocks, key, 24, 0)
    pos = _put(blocks, _SHORT_STRING, 4, pos)
    pos = _put(blocks, enc, 5, pos)
    pos = _put(blocks, len(codes), 6, pos)
    for c in codes:
        pos = _put(blocks, c, ENCODINGS[enc], pos)
    return blocks


def _be32(value: int) -> bytes:
    return int(value & 0xFFFFFFFF).to_bytes(4, "big")


class _Dynamic:
    """A dynamic store (records of ``8 + data`` bytes: ``[flags][length
    3B][next 4B][data]``); record 0 is reserved, as Neo4j reserves it."""

    def __init__(self, data_bytes: int):
        self.data = data_bytes
        self.records = [bytes(8 + data_bytes)]

    def add(self, payload: bytes) -> int:
        chunks = [payload[i:i + self.data]
                  for i in range(0, max(len(payload), 1), self.data)]
        first = len(self.records)
        for k, chunk in enumerate(chunks):
            nxt = first + k + 1 if k + 1 < len(chunks) else _NO_ID
            self.records.append(
                bytes([0x11]) + len(chunk).to_bytes(3, "big") + _be32(nxt)
                + chunk.ljust(self.data, b"\0"))
        return first

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(b"".join(self.records))


def _tokens(path: str, names: list[str], record: int) -> None:
    """A token store (``[inUse]``, a property count for property keys, then
    the name's dynamic id) and its 38-byte name store."""
    dyn = _Dynamic(30)
    with open(path, "wb") as f:
        for name in names:
            name_id = dyn.add(name.encode("utf-8"))
            body = (bytes(4) if record == 9 else b"") + _be32(name_id)
            f.write(bytes([1]) + body)
    dyn.write(path + (".keys" if record == 9 else ".names"))


def write_store(db_dir: str, src, dst, names: list[str], *,
                other_src=(), other_dst=()) -> None:
    """Write a Neo4j 3.5 store to ``db_dir``: ``len(names)`` nodes, the
    ``Relation`` edges ``src -> dst`` (dense ids, in this order) and the
    ``KNOWS`` edges ``other_src -> other_dst``.

    Node ``j`` is the internal record ``j`` below the deleted record 5 and
    ``j + 1`` from there, so ascending internal ids give back dense id
    ``j``. Its name is an inline short string in the encoding
    :func:`sample_name` gives node ``j`` where the name is that sample, in
    the dynamic string store where it is another string, and left out
    where it is ``None``. Names of nodes ``j % 3 == 1`` follow an
    INT property in their record; names of nodes ``j % 3 == 2`` sit in a
    second property record chained behind one that holds a DOUBLE."""
    os.makedirs(db_dir, exist_ok=True)
    _tokens(os.path.join(db_dir, "neostore.propertystore.db.index"),
            ["name", "age", "weight"], 9)
    _tokens(os.path.join(db_dir, "neostore.relationshiptypestore.db"),
            ["Relation", "KNOWS"], 5)
    _tokens(os.path.join(db_dir, "neostore.labeltokenstore.db"),
            ["Person"], 5)
    internal = [j if j < 5 else j + 1 for j in range(len(names))]

    strings = _Dynamic(120)
    props: list[bytes] = []

    def prop_record(blocks: list[int], nxt: int = _NO_ID) -> int:
        assert len(blocks) <= 4
        blocks = blocks + [0] * (4 - len(blocks))
        props.append(bytes([(nxt >> 32) & 0xF if nxt != _NO_ID else 0])
                     + _be32(_NO_ID) + _be32(nxt)
                     + b"".join(b.to_bytes(8, "big") for b in blocks))
        return len(props) - 1

    first_prop = {}
    for j, name in enumerate(names):
        if name is None:
            continue
        sample, enc = sample_name(j)
        if name == sample:
            blocks = short_string_blocks(0, name, enc)
        else:
            dyn = strings.add(name.encode("utf-8"))
            blocks = [0 | (_STRING << 24) | (dyn << 28)]
        if j % 3 == 1:
            blocks = [1 | (_INT << 24) | (30 + j) << 28] + blocks
        if j % 3 == 2:
            rid = prop_record(blocks)
            head = [2 | (_DOUBLE << 24), int(np.float64(j).view(np.int64))]
            first_prop[j] = prop_record(head, nxt=rid)
        else:
            first_prop[j] = prop_record(blocks)
    with open(os.path.join(db_dir, "neostore.propertystore.db"), "wb") as f:
        f.write(b"".join(props))
    strings.write(os.path.join(db_dir, "neostore.propertystore.db.strings"))

    n_records = internal[-1] + 1 if names else 0
    nodes = [bytes(15)] * n_records     # unused records: in-use bit 0
    for j, rec in enumerate(internal):
        fp = first_prop.get(j, _NO_ID)
        high = (fp >> 32) & 0xF if fp != _NO_ID else 0
        nodes[rec] = (bytes([1 | (high << 4)]) + _be32(_NO_ID) + _be32(fp)
                      + bytes(6))
    with open(os.path.join(db_dir, "neostore.nodestore.db"), "wb") as f:
        f.write(b"".join(nodes))

    rels = []
    edges = [(s, d, 0) for s, d in zip(src, dst)] + \
        [(s, d, 1) for s, d in zip(other_src, other_dst)]
    for k, (s, d, rtype) in enumerate(edges):
        if k == len(edges) // 2:        # a deleted relationship record
            rels.append(bytes([0]) + _be32(internal[0]) * 2 + bytes(25))
        rels.append(bytes([1]) + _be32(internal[int(s)])
                    + _be32(internal[int(d)]) + _be32(rtype)
                    + _be32(_NO_ID) * 4 + _be32(_NO_ID) + bytes(1))
    with open(os.path.join(db_dir, "neostore.relationshipstore.db"),
              "wb") as f:
        f.write(b"".join(rels))


LONG_NAME = "Daenerys of House Targaryen, " * 9


def store_names(n: int) -> list[str | None]:
    """The names :func:`write_store` gets for an ``n``-node store: every
    node its sample, node 4 the long name, node 9 none."""
    names = [sample_name(j)[0] for j in range(n)]
    names[4] = LONG_NAME
    names[9] = None
    return names


def expected_names(n: int) -> list[str]:
    """What a reader must give for :func:`store_names`: a node without the
    property is named by its internal id."""
    return [name if name is not None else str(j if j < 5 else j + 1)
            for j, name in enumerate(store_names(n))]


def write_synth_store(db_dir: str, spec: str = "synth:107x3@7") -> None:
    """``write_store`` of the port's ``spec`` graph (its edges in their
    source-sorted order), named by :func:`store_names`, with 20 ``KNOWS``
    edges beside them."""
    from ppr_tpu_torch.cli import load_dataset

    g = load_dataset(spec, device="cpu").graph
    src = g.edge_src[: g.m].numpy()
    dst = g.edge_dst[: g.m].numpy()
    rng = np.random.default_rng(5)
    write_store(db_dir, src, dst, store_names(g.n),
                other_src=rng.integers(0, g.n, 20),
                other_dst=rng.integers(0, g.n, 20))


# ---------------------------------------------------------------- tests
FIELDS = ("indptr", "indices", "edge_src", "edge_dst", "edge_mask",
          "edge_src_bydst", "edge_dst_bydst", "out_deg", "in_deg",
          "node_mask", "dense_out")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("neo") / "synth.db")
    write_synth_store(db)
    return db


def assert_same_graph(tg, jg):
    assert (tg.n, tg.m) == (jg.n, jg.m)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)


def test_store_matches_jax(store):
    from ppr_tpu.graph import neostore as jneo
    from ppr_tpu_torch.graph import neostore as tneo

    tds = tneo.load_neo4j_store(store, device="cpu")
    jds = jneo.load_neo4j_store(store)
    assert tds.name == jds.name == "synth"
    assert tds.names == jds.names == expected_names(107)
    assert_same_graph(tds.graph, jds.graph)
    # the KNOWS edges are in: 20 beside the Relation ones
    assert tds.graph.m == 20 + tneo.load_neo4j_store(
        store, rel_type="Relation", device="cpu").graph.m


@pytest.mark.parametrize("reader", ["read_property_key_tokens",
                                    "read_relationship_type_tokens",
                                    "read_label_tokens"])
def test_tokens_match_jax(store, reader):
    from ppr_tpu.graph import neostore as jneo
    from ppr_tpu_torch.graph import neostore as tneo

    want = {"read_property_key_tokens": {0: "name", 1: "age", 2: "weight"},
            "read_relationship_type_tokens": {0: "Relation", 1: "KNOWS"},
            "read_label_tokens": {0: "Person"}}[reader]
    assert getattr(tneo, reader)(store) == getattr(jneo, reader)(store) \
        == want


def test_every_encoding_is_written(store):
    """The store holds a short string of each encoding, and both readers
    decode each one to the name written."""
    from ppr_tpu.graph import neostore as jneo
    from ppr_tpu_torch.graph import neostore as tneo

    encs = {sample_name(j)[1] for j, name in enumerate(store_names(107))
            if name == sample_name(j)[0]}
    assert encs == set(ENCODINGS)
    for j in range(len(ENCODINGS)):
        name, enc = sample_name(j)
        blocks = short_string_blocks(0, name, enc)
        assert tneo._decode_short_string(blocks) == \
            jneo._decode_short_string(blocks) == name


def _unit_blocks(enc, bpc, codes, key=0):
    blocks: list[int] = []
    pos = _put(blocks, key, 24, 0)
    pos = _put(blocks, _SHORT_STRING, 4, pos)
    pos = _put(blocks, enc, 5, pos)
    pos = _put(blocks, len(codes), 6, pos)
    for c in codes:
        pos = _put(blocks, c, bpc, pos)
    return blocks


@pytest.mark.parametrize("enc,bpc,codes,want", [
    (4, 5, [8, 9, 0, 26], "hi z"),                 # LOWER
    (3, 5, [7, 15, 20], "GOT"),                    # UPPER
    (1, 4, [4, 2], "42"),                          # NUMERICAL
    (10, 8, [0xE9, 0x61], "\xe9a"),                # LATIN1
    (0, 8, list("ok".encode()), "ok"),             # UTF8
    (7, 6, [0x01, 0x21, 0x3B, 0x1B, 0x00], "Aa50 "),   # ALPHANUM
], ids=["lower", "upper", "numerical", "latin1", "utf8", "alphanum"])
def test_short_string_unit_cases(enc, bpc, codes, want):
    """The unit cases of ``tests/test_neostore.py``, in both packages."""
    from ppr_tpu.graph import neostore as jneo
    from ppr_tpu_torch.graph import neostore as tneo

    blocks = _unit_blocks(enc, bpc, codes)
    assert tneo._decode_short_string(blocks) == \
        jneo._decode_short_string(blocks) == want


def test_is_neo4j_store(store, tmp_path):
    from ppr_tpu.graph import neostore as jneo
    from ppr_tpu_torch.graph import neostore as tneo

    for mod in (tneo, jneo):
        assert mod.is_neo4j_store(store)
        assert not mod.is_neo4j_store(str(tmp_path))
        assert not mod.is_neo4j_store(
            os.path.join(store, "neostore.nodestore.db"))


def test_rel_type_filter(store):
    from ppr_tpu.graph import neostore as jneo
    from ppr_tpu_torch.graph import neostore as tneo

    for rel in ("Relation", "KNOWS"):
        tds = tneo.load_neo4j_store(store, rel_type=rel, device="cpu")
        jds = jneo.load_neo4j_store(store, rel_type=rel)
        assert_same_graph(tds.graph, jds.graph)
    assert tds.graph.m == 20
    for mod, kwargs in ((tneo, {"device": "cpu"}), (jneo, {})):
        with pytest.raises(ValueError, match="no relationship type"):
            mod.load_neo4j_store(store, rel_type="NOPE", **kwargs)


def test_relation_edges_are_the_synth_graph(store):
    """``--db <store>`` keeps the ``Relation`` edges: the graph of
    ``synth:107x3@7``, array for array (what ``chip_smoke.py``'s
    ``[neostore]`` phase relies on)."""
    from ppr_tpu_torch.cli import load_dataset

    got = load_dataset(store, rel="Relation", device="cpu").graph
    want = load_dataset("synth:107x3@7", device="cpu").graph
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_cli_dispatch_matches_jax(store):
    from ppr_tpu import cli as jcli
    from ppr_tpu_torch import cli as tcli

    tds = tcli.load_dataset(store, rel="Relation", device="cpu")
    jds = jcli.load_dataset(store, rel="Relation")
    assert tds.names == jds.names
    assert_same_graph(tds.graph, jds.graph)
    for load, kwargs in ((tcli.load_dataset, {"device": "cpu"}),
                         (jcli.load_dataset, {})):
        with pytest.raises(ValueError):
            load(store, rel="NOPE", **kwargs)


def test_top_k_through_store_loaded_graph(store):
    """A FORA top-k query on the store-loaded graph returns named hits."""
    from ppr_tpu_torch.graph import neostore as tneo
    from ppr_tpu_torch.service import PPRService

    tds = tneo.load_neo4j_store(store, rel_type="Relation", device="cpu")
    hits = PPRService.from_dataset(tds, alpha=0.15, k=10, seed=3).top_k(
        [3, 4], k=10)
    for row in hits:
        assert len(row) >= 1
        assert all(isinstance(h.name, str) and h.name for h in row)
        assert [h.name for h in row] == [tds.names[h.node] for h in row]
    assert tds.names[4] == LONG_NAME
