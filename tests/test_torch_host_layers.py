"""The port's own host layers against the JAX package's originals.

snappytpu_torch keeps copies of snappytpu's JAX-free layers (format, model,
stream.framing, the native runtime cpu, bench.corpus and bench.metrics) so
that it imports nothing of snappytpu.  Each copy is held here against its
original on the same inputs: equal constants, equal arrays and bytes, and
the same exception (by type name and message) where the original raises.
The native runtimes are two builds of one source: equal outputs and error
codes.  Tolerance: exact everywhere.
"""

import glob
import os

import numpy as np
import pytest

from snappytpu import cpu as jax_cpu
from snappytpu.bench import corpus as jax_corpus
from snappytpu.bench import metrics as jax_metrics
from snappytpu.format import constants as jax_C
from snappytpu.format import varint as jax_varint
from snappytpu.model import decode as jax_decode
from snappytpu.model import encode as jax_encode
from snappytpu.stream import framing as jax_framing
from snappytpu_torch import cpu
from snappytpu_torch.bench import corpus, metrics
from snappytpu_torch.format import constants as C
from snappytpu_torch.format import varint
from snappytpu_torch.model import decode, encode
from snappytpu_torch.stream import framing

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "*.snappy")))


def _outcome(fn, *args):
    """fn(*args) -> ("ok", value) or ("raise", exception type name, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the test compares which one
        return ("raise", type(e).__name__, str(e))


def _same(a, b):
    if a[0] != b[0]:
        return False
    if a[0] == "raise":
        return a == b
    return _equal(a[1], b[1])


def _equal(x, y):
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return isinstance(x, np.ndarray) and isinstance(y, np.ndarray) and x.dtype == y.dtype and np.array_equal(x, y)
    if isinstance(x, (tuple, list)):
        return type(x) is type(y) and len(x) == len(y) and all(_equal(a, b) for a, b in zip(x, y))
    return type(x) is type(y) and x == y


def _golden_ops(path):
    with open(path, "rb") as f:
        arr = np.frombuffer(f.read(), np.uint8)
    n, start = jax_varint.decode_varint(arr)
    return arr[start:], n


# ---- format ------------------------------------------------------------------

CONSTANTS = sorted(n for n, v in vars(jax_C).items() if not n.startswith("_") and isinstance(v, (int, float, str)))


def test_the_constants_are_all_there():
    mine = sorted(n for n, v in vars(C).items() if not n.startswith("_") and isinstance(v, (int, float, str)))
    assert mine == CONSTANTS and len(CONSTANTS) > 10


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant(name):
    assert getattr(C, name) == getattr(jax_C, name)


HELPER_ARGS = {
    "literal_header_len": [(n,) for n in [*range(0, 1 << 17, 97), 1 << 24, (1 << 24) + 1]],
    "copy_op_len": [(n, d) for n in range(1, 70) for d in (1, 2047, 2048, 65535, 65536)],
}


@pytest.mark.parametrize("fn", sorted(HELPER_ARGS))
def test_format_helpers(fn):
    for a in HELPER_ARGS[fn]:
        assert getattr(C, fn)(*a) == getattr(jax_C, fn)(*a), a


VARINTS = [0, 1, 127, 128, 255, 300, (1 << 14) - 1, 1 << 14, 65536, (1 << 21) + 5, (1 << 31) - 1, 1 << 31,
           (1 << 32) + 7, (1 << 56) - 1, (1 << 63) + 3, (1 << 64) - 1]


@pytest.mark.parametrize("n", VARINTS)
def test_varint_round_trip(n):
    enc = varint.encode_varint(n)
    assert enc == jax_varint.encode_varint(n)
    assert varint.varint_len(n) == jax_varint.varint_len(n) == len(enc)
    for buf, pos in ((enc, 0), (b"\x07" + enc + b"\x01", 1), (np.frombuffer(enc, np.uint8), 0)):
        assert varint.decode_varint(buf, pos) == jax_varint.decode_varint(buf, pos) == (n, pos + len(enc))


VARINT_ERRORS = [
    ("encode_varint", (-1,)),
    ("varint_len", (-5,)),
    ("decode_varint", (b"",)),
    ("decode_varint", (b"\x80",)),
    ("decode_varint", (b"\xff" * 9,)),
    ("decode_varint", (b"\xff" * 11,)),
    ("decode_varint", (b"\x80" * 10 + b"\x01",)),
    ("decode_varint", (b"\x05", 1)),
]


@pytest.mark.parametrize("case", range(len(VARINT_ERRORS)))
def test_varint_errors(case):
    fn, args = VARINT_ERRORS[case]
    got, want = _outcome(getattr(varint, fn), *args), _outcome(getattr(jax_varint, fn), *args)
    assert want[0] == "raise" and got == want


# ---- model -------------------------------------------------------------------


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
def test_decode_ops_on_golden_streams(path):
    ops, n = _golden_ops(path)
    got = decode.decode_ops(ops, n)
    assert np.array_equal(got, jax_decode.decode_ops(ops, n))
    with open(path[: -len(".snappy")] + ".raw", "rb") as f:
        assert got.tobytes() == f.read()
    p = 0
    while p < ops.size:  # every op of the stream parses alike
        op = decode.parse_op(ops, p)
        assert op == jax_decode.parse_op(ops, p)
        p = op[3]


@pytest.mark.parametrize("seed", range(6))
def test_decode_ops_and_parse_op_on_mutations(seed):
    """Mutated, truncated and re-lengthed golden streams: the same bytes or
    the same exception from decode_ops, and the same op or exception from
    parse_op at every offset of the first 300 bytes."""
    rng = np.random.default_rng(300 + seed)
    for _ in range(25):
        ops, n = _golden_ops(GOLDEN[int(rng.integers(0, len(GOLDEN)))])
        arr = ops.copy()
        for _m in range(int(rng.integers(1, 5))):
            arr[int(rng.integers(0, arr.size))] = int(rng.integers(0, 256))
        if rng.random() < 0.3:
            arr = arr[: int(rng.integers(0, arr.size + 1))]
        if rng.random() < 0.3:
            n = int(rng.integers(0, n + 100))
        assert _same(_outcome(decode.decode_ops, arr, n), _outcome(jax_decode.decode_ops, arr, n))
        for p in range(min(arr.size, 300)):
            assert _same(_outcome(decode.parse_op, arr, p), _outcome(jax_decode.parse_op, arr, p))


@pytest.mark.parametrize("name", ["empty", "one_byte", "32k_ff", "alice_like_text", "two_blocks_mixed"])
def test_model_codec(name):
    data = jax_corpus.edge_case_corpus()[name]
    comp = encode.compress(data)
    assert comp == jax_encode.compress(data)
    assert decode.decompress(comp) == jax_decode.decompress(comp) == data
    block = np.frombuffer(data[: C.MAX_BLOCK_SIZE], np.uint8)
    assert encode.encode_block(block) == jax_encode.encode_block(block)


# ---- stream.framing ----------------------------------------------------------


@pytest.mark.parametrize("size", [0, 1, 65535, 65536, 65537, 200_000])
def test_pack_blocks_and_assemble(size):
    data = np.frombuffer(jax_corpus.mixed(size, seed=size), np.uint8)
    got, want = framing.pack_blocks(data), jax_framing.pack_blocks(data)
    assert _equal(got, want)
    blocks, lens = got
    comp_lens = (lens // 3).astype(np.int32)
    assert framing.assemble_stream(blocks, comp_lens, size) == jax_framing.assemble_stream(blocks, comp_lens, size)


@pytest.mark.parametrize("path", GOLDEN, ids=os.path.basename)
def test_split_and_pad(path):
    with open(path, "rb") as f:
        arr = np.frombuffer(f.read(), np.uint8)
    assert framing.read_preamble(arr) == jax_framing.read_preamble(arr)
    ops, n = _golden_ops(path)
    for fn in ("split_ops_stream", "split_ops_windowed"):
        got, want = _outcome(getattr(framing, fn), ops, n), _outcome(getattr(jax_framing, fn), ops, n)
        assert _same(got, want), fn
        if got[0] == "ok":
            assert _equal(framing.pad_chunks(got[1][0]), jax_framing.pad_chunks(want[1][0]))
    # an unaligned stream (a 5-byte literal shifts every later op) and a
    # corrupt one: the windowed split takes the first, both refuse the second
    shifted = np.concatenate([np.frombuffer(bytes([4 << 2]) + b"abcde", np.uint8), ops])
    bad = ops.copy()
    bad[ops.size // 2] ^= 0x41
    for stream, total in ((shifted, n + 5), (bad, n), (ops[:-1], n)):
        for fn in ("split_ops_stream", "split_ops_windowed"):
            assert _same(_outcome(getattr(framing, fn), stream, total), _outcome(getattr(jax_framing, fn), stream, total))


def test_pad_chunks_refuses_an_oversized_chunk():
    chunks = [np.zeros(10, np.uint8), np.zeros(C.MAX_COMPRESSED_BLOCK_SIZE + 1, np.uint8)]
    want = _outcome(jax_framing.pad_chunks, chunks)
    assert want[0] == "raise" and _outcome(framing.pad_chunks, chunks) == want


# ---- bench -------------------------------------------------------------------

GENERATORS = ["random_bytes", "text", "structured_binary", "low_entropy", "mixed"]


@pytest.mark.parametrize("seed", [0, 5, 42])
@pytest.mark.parametrize("gen", GENERATORS)
def test_corpus_generator(gen, seed):
    for size in (0, 1, 4097, 150_000):
        assert getattr(corpus, gen)(size, seed=seed) == getattr(jax_corpus, gen)(size, seed=seed)


def test_corpus_fixture_sets():
    assert corpus.constant(1000, 7) == jax_corpus.constant(1000, 7)
    assert corpus.edge_case_corpus() == jax_corpus.edge_case_corpus()
    assert corpus.size_sweep(3) == jax_corpus.size_sweep(3)


RESULTS = [
    dict(phase="compress", input_size=1 << 20, output_size=400_000, time_taken=0.0123),
    dict(phase="decompress", input_size=400_000, output_size=1 << 20, time_taken=0.002, backend="cpu"),
    dict(phase="compress", input_size=0, output_size=1, time_taken=0.0, n_chips=4, n_hosts=2),
]


@pytest.mark.parametrize("case", range(len(RESULTS)))
def test_metrics_csv_rows_and_report(tmp_path, case):
    got, want = tmp_path / "port.csv", tmp_path / "jax.csv"
    for k in range(case + 1):
        metrics.write_result_csv(str(got), metrics.Result(**RESULTS[k]))
        jax_metrics.write_result_csv(str(want), jax_metrics.Result(**RESULTS[k]))
    assert got.read_bytes() == want.read_bytes()
    assert metrics.CSV_FIELDS == jax_metrics.CSV_FIELDS
    r, jr = metrics.Result(**RESULTS[case]), jax_metrics.Result(**RESULTS[case])
    assert (r.report(), r.comp_ratio, r.speed_mbps) == (jr.report(), jr.comp_ratio, jr.speed_mbps)
    other = tmp_path / "other.csv"
    other.write_bytes(want.read_bytes()[:-3] + b"xyz\n")
    assert metrics.compare_files(str(got), str(other)) == jax_metrics.compare_files(str(got), str(other)) > 0


# ---- the native runtime ------------------------------------------------------


@pytest.fixture(autouse=False)
def native():
    if not (cpu.available and jax_cpu.available):
        pytest.skip("the native runtimes need g++")


def test_the_port_builds_its_own_library(native):
    """The port's library lies in its own _build/ under a name that hashes
    the source, the flags and the host's CPU, not beside the JAX package's."""
    path = cpu._lib_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(os.path.dirname(os.path.dirname(cpu.__file__)), "_build")
    assert os.path.basename(path).startswith("libsnappy_cpu-")
    with open(cpu._SRC, "rb") as a, open(os.path.join(os.path.dirname(jax_cpu.__file__), "csrc", "snappy_cpu.cc"),
                                         "rb") as b:
        assert a.read() == b.read()


def _native_streams():
    out = [(name, jax_corpus.edge_case_corpus()[name]) for name in ("one_byte", "32k_ff", "alice_like_text",
                                                                    "two_blocks_mixed", "low_entropy_runs")]
    return out + [("mixed300k", jax_corpus.mixed(300_000, seed=77))]


@pytest.mark.parametrize("case", range(6))
def test_native_codec(native, case):
    _name, data = _native_streams()[case]
    comp = cpu.compress(data)
    assert comp == jax_cpu.compress(data)
    assert cpu.decompress(comp) == jax_cpu.decompress(comp) == data
    arr = np.frombuffer(comp, np.uint8)
    n, start = jax_varint.decode_varint(arr)
    ops = arr[start:]
    got, want = _outcome(cpu.scan_ops, ops, n), _outcome(jax_cpu.scan_ops, ops, n)
    assert got[0] == want[0] == "ok" and _equal(got[1], want[1])
    offs, lens = got[1]
    rows, clens = cpu.split_rows(ops, offs, C.MAX_COMPRESSED_BLOCK_SIZE)
    assert _equal((rows, clens), jax_cpu.split_rows(ops, offs, C.MAX_COMPRESSED_BLOCK_SIZE))
    assert cpu.compact(rows, clens) == jax_cpu.compact(rows, clens) == ops.tobytes()
    for max_recs in (12288, 64):  # 64 records overflow (-9) on the longer blocks
        got = cpu.build_tapes(rows, clens, lens, 512, 512 + C.MAX_COMPRESSED_BLOCK_SIZE, max_recs)
        want = jax_cpu.build_tapes(rows, clens, lens, 512, 512 + C.MAX_COMPRESSED_BLOCK_SIZE, max_recs)
        assert _equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_native_errors_on_mutations(native, seed):
    """Mutated and truncated streams: the same bytes or the same NativeError
    message from decompress and scan_ops, and the same tapes and error codes
    (-10 malformed) from build_tapes."""
    rng = np.random.default_rng(800 + seed)
    base = [np.frombuffer(jax_cpu.compress(d), np.uint8) for _n, d in _native_streams()]
    for _ in range(30):
        arr = base[int(rng.integers(0, len(base)))].copy()
        for _m in range(int(rng.integers(1, 4))):
            arr[int(rng.integers(0, arr.size))] ^= int(rng.integers(1, 256))
        if rng.random() < 0.2:
            arr = arr[: int(rng.integers(1, arr.size + 1))]
        assert _same(_outcome(cpu.decompress, arr), _outcome(jax_cpu.decompress, arr))
        n, start = jax_varint.decode_varint(arr)
        if n > 1 << 26:
            continue  # a mutated preamble: the scan's block table would be huge
        got, want = _outcome(cpu.scan_ops, arr[start:], n), _outcome(jax_cpu.scan_ops, arr[start:], n)
        assert _same(got, want)
        rows = np.zeros((2, C.MAX_COMPRESSED_BLOCK_SIZE), np.uint8)
        k = min(arr.size - start, C.MAX_COMPRESSED_BLOCK_SIZE)
        rows[0, :k] = arr[start : start + k]
        cl, ol = np.array([k, 0], np.int32), np.array([min(n, C.MAX_BLOCK_SIZE), 0], np.int32)
        args = (rows, cl, ol, 512, 512 + C.MAX_COMPRESSED_BLOCK_SIZE, 12288)
        assert _equal(cpu.build_tapes(*args), jax_cpu.build_tapes(*args))


def test_native_split_and_compact_errors(native):
    stream = np.arange(1000, dtype=np.int64).astype(np.uint8)
    cuts = np.array([0, 10, 900], np.int64)
    for fn, args in (("split_rows", (stream, cuts, 64)), ("compact", (np.zeros((2, 8), np.uint8), np.array([5, -3])))):
        got, want = _outcome(getattr(cpu, fn), *args), _outcome(getattr(jax_cpu, fn), *args)
        assert want[0] == "raise" and got == want
    assert _equal(cpu.split_rows(stream, cuts, 1024), jax_cpu.split_rows(stream, cuts, 1024))
