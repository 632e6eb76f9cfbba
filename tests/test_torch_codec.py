"""The port's binary TLV codec against the JAX package's, byte for byte.

The C++ daemons (``native/serverd.cpp``), the C client library
(``native/libadlb.cpp``) and the Python codec must agree on every frame, and
the port copies both sides. Here the same seeded frames, one set per tag,
are built in both packages and encoded by each: the bytes must be equal,
and each side must decode the other's bytes to the same message. Both
implementations are held: the Python twin (``py``) and the compiled core
(``c``, ``native/codec.cpp``), which the port builds from its own copy into
``adlb_tpu_torch/_build/native/``.
"""

import pickle
import random

import pytest

import tests.conftest  # noqa: F401  (JAX on the CPU platform)

from adlb_tpu.runtime import codec as ref_codec
from adlb_tpu.runtime import messages as ref_messages
from adlb_tpu_torch.native import build as port_build
from adlb_tpu_torch.runtime import codec as port_codec
from adlb_tpu_torch.runtime import messages as port_messages

_KIND_I64, _KIND_BYTES, _KIND_LIST, _KIND_F64, _KIND_BLIST, _KIND_FLIST = \
    range(6)
FRAMES_PER_TAG = 12


def _impl(mod, which):
    """(encode_iov, decode) of one codec module's ``py`` or ``c`` twin."""
    if which == "py":
        return mod.encode_binary_iov_py, mod.decode_binary_py
    if not mod._load_c_codec():
        pytest.skip("compiled codec unavailable (no toolchain)")
    return mod._c_encode_iov, mod._c_decode


def _value(rng, kind):
    if kind == _KIND_I64:
        return rng.choice([0, 1, -1, 97, 2**31, -(2**31), 2**62,
                           rng.randrange(-(2**40), 2**40)])
    if kind == _KIND_BYTES:
        n = rng.choice([0, 1, 7, ref_codec.IOV_INLINE_MAX - 1,
                        ref_codec.IOV_INLINE_MAX, 4096, 70000])
        return rng.randbytes(n)
    if kind == _KIND_LIST:
        return [rng.randrange(-(2**40), 2**40)
                for _ in range(rng.choice([0, 1, 5, 300]))]
    if kind == _KIND_F64:
        return rng.choice([0.0, -1.5, 1e300, float(rng.randrange(10**6))])
    if kind == _KIND_BLIST:
        return [rng.randbytes(rng.randrange(0, 300))
                for _ in range(rng.choice([0, 1, 8]))]
    return [rng.uniform(-1e6, 1e6) for _ in range(rng.choice([0, 1, 9]))]


def _frames(seed):
    """(tag name, src, data) triples: FRAMES_PER_TAG random frames of every
    tag, each with a random subset of the wire fields (None values are
    encoded by omission)."""
    rng = random.Random(seed)
    names = sorted(ref_codec.FIELDS)
    out = []
    for tag in ref_messages.Tag:
        for _ in range(FRAMES_PER_TAG):
            data = {}
            for name in rng.sample(names, rng.randrange(0, 10)):
                kind = ref_codec.FIELDS[name][1]
                data[name] = None if rng.random() < 0.1 else _value(rng, kind)
            if tag.name == "AM_APP":  # app messages carry bytes only
                data["payload"] = rng.randbytes(rng.randrange(0, 64))
            out.append((tag.name, rng.randrange(-1, 1 << 20), data))
    return out


def _msgs(triple):
    name, src, data = triple
    return (ref_messages.Msg(tag=ref_messages.Tag[name], src=src,
                             data=dict(data)),
            port_messages.Msg(tag=port_messages.Tag[name], src=src,
                              data=dict(data)))


def _flat(parts) -> bytes:
    return b"".join(bytes(p) for p in parts)


def _same(a, b) -> bool:
    return (a.tag.name, a.src, a.data) == (b.tag.name, b.src, b.data)


def test_protocol_tables_equal():
    assert [(t.name, t.value) for t in port_messages.Tag] \
        == [(t.name, t.value) for t in ref_messages.Tag]
    assert {t.name: w for t, w in port_codec.WIRE_TAG.items()} \
        == {t.name: w for t, w in ref_codec.WIRE_TAG.items()}
    assert port_codec.FIELDS == ref_codec.FIELDS
    assert port_codec.IOV_INLINE_MAX == ref_codec.IOV_INLINE_MAX
    assert port_codec.BINARY_MAGIC == ref_codec.BINARY_MAGIC


@pytest.mark.parametrize("which", ["py", "c"])
@pytest.mark.parametrize("seed", [0, 1])
def test_frames_byte_equal_and_cross_decode(which, seed):
    ref_enc, ref_dec = _impl(ref_codec, which)
    port_enc, port_dec = _impl(port_codec, which)
    frames = _frames(seed)
    assert {f[0] for f in frames} == {t.name for t in port_messages.Tag}
    for i, triple in enumerate(frames):
        ref_m, port_m = _msgs(triple)
        assert port_codec.encodable(port_m) == ref_codec.encodable(ref_m)
        ref_bytes = _flat(ref_enc(ref_m))
        port_bytes = _flat(port_enc(port_m))
        assert port_bytes == ref_bytes, f"frame {i} ({triple[0]})"
        assert _same(port_dec(ref_bytes), ref_dec(port_bytes)), i
        assert port_dec(ref_bytes).tag is port_m.tag


def test_port_c_codec_is_built_from_the_port():
    assert port_codec._load_c_codec()
    assert port_build._CODEC_LIB.startswith(port_build.BUILD_DIR)
    assert "/adlb_tpu_torch/_build/native/" in port_build._CODEC_LIB
    assert port_build.codec_error() is None


@pytest.mark.parametrize("which", ["py", "c"])
def test_known_corpus_byte_equal(which):
    """The edge corpus of the JAX package's codec tests: empty and large
    payloads, both sides of the inline threshold, frozenset req_types,
    bools, job and trace ids on and off, batched put deltas."""
    ref_enc, ref_dec = _impl(ref_codec, which)
    port_enc, port_dec = _impl(port_codec, which)
    big = b"\xa5" * (2 << 20)
    inline = ref_codec.IOV_INLINE_MAX
    corpus = [
        ("FA_PUT", 0, dict(payload=b"", work_type=1, prio=0, target_rank=-1,
                           answer_rank=-1, common_len=0, common_server=-1,
                           common_seqno=-1)),
        ("FA_PUT", 3, dict(payload=big, work_type=2, prio=-7)),
        ("FA_PUT", 1, dict(payload=b"x" * (inline - 1))),
        ("FA_PUT", 1, dict(payload=b"x" * inline, job_id=7)),
        ("FA_PUT", 1, dict(payload=b"x", put_id=3, trace_id=(2 << 32) | 9)),
        ("FA_RESERVE", 0, dict(req_types=frozenset({1, 2, 9}), hang=True,
                               rqseqno=42)),
        ("FA_RESERVE", 0, dict(req_types=None, hang=False, rqseqno=1)),
        ("TA_RESERVE_RESP", 6, dict(rc=1, payloads=[big[:4096], b"", b"z"],
                                    work_types=[1, 2, 3], prios=[0, -1, 5],
                                    answer_ranks=[-1, 0, 2],
                                    times_on_q=[0.0, 0.5, 1e9])),
        ("SS_STATE_DELTA", 4, dict(seqnos=list(range(1000)),
                                   work_types=[1] * 1000, prios=[0] * 1000,
                                   work_lens=[64] * 1000, nbytes=64000)),
        ("FA_LOCAL_APP_DONE", 9, {}),
        ("TA_INFO_GET_RESP", 6, dict(rc=1, value=3.5)),
    ]
    for triple in corpus:
        ref_m, port_m = _msgs(triple)
        assert ref_codec.encodable(ref_m) and port_codec.encodable(port_m)
        port_bytes = _flat(port_enc(port_m))
        ref_bytes = _flat(ref_enc(ref_m))
        assert port_bytes == ref_bytes, triple[0]
        assert _same(port_dec(ref_bytes), ref_dec(port_bytes)), triple[0]


def test_pickled_abort_is_recognised_by_the_port_client():
    """libadlb honours a pickled frame as the TA_ABORT fan-out only when the
    body holds the pickled Msg's module path; the port's Python servers
    pickle ``adlb_tpu_torch.runtime.messages.Msg``, and the port's copy of
    libadlb searches for that path."""
    m = port_messages.msg(port_messages.Tag.TA_ABORT, 0, code=-2)
    body = pickle.dumps(m, protocol=pickle.HIGHEST_PROTOCOL)
    assert body[0] == 0x80 and b"adlb_tpu_torch" in body
    src = (port_build._DIR + "/libadlb.cpp")
    with open(src) as f:
        assert 'body.find("adlb_tpu_torch")' in f.read()
