"""The port's JPEG reader against ``cv2.imread``, and what it unlocks.

``csrc/host.cpp::jpeg_decode`` through ``runtime/jpeg.py::read_jpeg`` and
``runtime/png.py::imread_bgr``: byte for byte equal to cv2 (libjpeg-turbo's
islow IDCT and fancy upsampling) on JPEGs that ``cv2.imencode`` writes here
from the committed example and from seeded noise, at quality 50 and 95, every
chroma sampling cv2 writes, baseline, progressive, optimised Huffman and with
restart markers, grayscale, from 1x1 to 1200x1920, under the 8 EXIF
orientations; the files it refuses; the committed fixtures and their cv2
hashes; and, against the JAX package, the folder and YOLO loaders, frame
sources and ``build_matched_rank_dataset`` over JPEG files."""

import hashlib
import io
import os
import struct
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from manual_yolo_tpu.runtime import capture as jax_capture  # noqa: E402
from manual_yolo_tpu.train import data as jax_data  # noqa: E402
from manual_yolo_tpu.train import matched_crops as jax_matched  # noqa: E402
from manual_yolo_tpu_torch.runtime import capture as pt_capture  # noqa: E402
from manual_yolo_tpu_torch.runtime import jpeg as pt_jpeg  # noqa: E402
from manual_yolo_tpu_torch.runtime import native  # noqa: E402
from manual_yolo_tpu_torch.runtime.png import imread_bgr  # noqa: E402
from manual_yolo_tpu_torch.train import data as pt_data  # noqa: E402
from manual_yolo_tpu_torch.train import matched_crops as pt_matched  # noqa: E402

import torch_jpeg_cases as cases  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "docs", "examples", "poker_labeled.png")
SAMPLINGS = ["444", "422", "420", "440", "411"]
MODES = {"baseline": [], "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
         "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1], "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]}


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the repo's persistent cache."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


@pytest.fixture(scope="module")
def example():
    return cv2.imread(EXAMPLE)


def _encode(img, quality, sampling, mode="baseline") -> bytes:
    params = cases.encode_params(cv2, quality, sampling, False, 0) + MODES[mode]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _check(tmp_path, data: bytes, name: str = "x.jpg"):
    """The port's read of ``data`` equals cv2's, byte for byte."""
    path = tmp_path / name
    path.write_bytes(data)
    ref = cv2.imread(str(path))
    assert ref is not None
    got = imread_bgr(str(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape and got.flags.c_contiguous
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("quality", [50, 95])
def test_example_decodes_as_cv2(tmp_path, example, quality, sampling, mode):
    _check(tmp_path, _encode(example, quality, sampling, mode))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("quality", [50, 95])
def test_noise_decodes_as_cv2(tmp_path, quality, sampling, mode):
    """Seeded noise at an odd size: every coefficient busy, partial MCUs."""
    noise = np.random.default_rng(quality).integers(0, 256, (75, 131, 3), np.uint8)
    _check(tmp_path, _encode(noise, quality, sampling, mode))


@pytest.mark.parametrize("mode", ["baseline", "progressive"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("hw", [(1, 1), (17, 33), (1200, 1920)], ids=["1x1", "17x33", "1200x1920"])
def test_sizes_decode_as_cv2(tmp_path, hw, sampling, mode):
    """Widths and heights that are not multiples of 8 or 16 (MCU padding,
    chroma planes at most 2 samples wide), and a full-size frame."""
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), np.uint8)
    _check(tmp_path, _encode(img, 90, sampling, mode))


@pytest.mark.parametrize("mode", list(MODES))
def test_grayscale_gives_three_equal_channels(tmp_path, example, mode):
    gray = cv2.cvtColor(example, cv2.COLOR_BGR2GRAY)
    got = _check(tmp_path, _encode(gray, 85, "444", mode))
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 1] == got[..., 2]).all()


def _exif_app1(orientation: int, order: bytes) -> bytes:
    e = "<" if order == b"II" else ">"
    tiff = (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
            + struct.pack(e + "HHIHH", 0x010F, 2, 4, 0, 0)  # Make, an entry before
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["little", "big"])
@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_as_cv2(tmp_path, example, orientation, order):
    """An APP1 segment spliced in after SOI: 1-8 turn the image as cv2 does
    (5-8 swap height and width), 0 and 9 leave it."""
    data = _encode(example[:45, :70], 90, "420")
    got = _check(tmp_path, data[:2] + _exif_app1(orientation, order) + data[2:])
    assert got.shape[:2] == ((70, 45) if 5 <= orientation <= 8 else (45, 70))
    assert pt_jpeg.exif_orientation(_exif_app1(orientation, order)[4:]) == orientation


def _segments(data: bytes):
    """(marker, start, end) of each segment before the first SOS."""
    pos = 2
    while data[pos + 1] != 0xDA:
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        yield data[pos + 1], pos, pos + 2 + length
        pos += 2 + length


@pytest.mark.parametrize("before", ["app1", "dqt", "sof", "sos"])
def test_stray_bytes_before_a_marker_decode_as_cv2(tmp_path, example, before):
    """Bytes that are no marker between two segments, where libjpeg warns of
    extraneous data and reads on: cv2's image. Before an EXIF APP1 (6, a
    quarter turn) the orientation is still found and applied."""
    data = _encode(example[:45, :70], 90, "420")
    segs = list(_segments(data))
    stray = b"\x00\x13\x37\x00"
    if before == "app1":
        at = segs[0][2]
        data = data[:at] + stray + _exif_app1(6, b"II") + data[at:]
    else:
        at = segs[-1][2] if before == "sos" else next(
            s for m, s, _ in segs if m == {"dqt": 0xDB, "sof": 0xC0}[before])
        data = data[:at] + stray + data[at:]
    got = _check(tmp_path, data)
    assert got.shape[:2] == ((70, 45) if before == "app1" else (45, 70))


def test_default_huffman_tables_as_cv2(tmp_path, example):
    """A baseline file without DHT segments (motion-JPEG frames) decodes with
    the standard tables, as libjpeg-turbo does."""
    data = _encode(example[:200, :300], 90, "420")
    segs = list(_segments(data))
    assert 0xC4 in [m for m, _, _ in segs]
    stripped = (data[:2] + b"".join(data[s:e] for m, s, e in segs if m != 0xC4)
                + data[segs[-1][2]:])
    assert 0xC4 not in [m for m, _, _ in _segments(stripped)]
    _check(tmp_path, stripped)


@pytest.mark.parametrize("kw", [{"subsampling": 0, "quality": 80}, {"subsampling": 2},
                                {"subsampling": 0, "keep_rgb": True}],
                         ids=["ycc444", "ycc420", "rgb"])
def test_rgb_and_pil_written_files_as_cv2(tmp_path, example, kw):
    """Another encoder's files: Pillow's YCbCr and RGB (Adobe transform 0)
    JPEGs read as cv2 reads them."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(example[:150, :220, ::-1]).save(buf, "JPEG", **kw)
    _check(tmp_path, buf.getvalue())


def _expect_refused(tmp_path, data: bytes, match: str):
    path = tmp_path / "bad.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"bad.jpg: .*{match}"):
        imread_bgr(str(path))


def test_truncated_file_raises(tmp_path, example):
    """cv2 returns a partial image (the rest grey); the port raises."""
    data = _encode(example[:120, :160], 90, "420")
    path = tmp_path / "bad.jpg"
    path.write_bytes(data[:len(data) // 2])
    assert cv2.imread(str(path)) is not None
    _expect_refused(tmp_path, data[:len(data) // 2], "ends early")
    prog = _encode(example[:120, :160], 90, "420", "progressive")
    sos = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    _expect_refused(tmp_path, prog[:sos[3]] + b"\xff\xd9", "incomplete progressive")
    _expect_refused(tmp_path, data[:len(data) - 1000] + b"\xff\xd9", "ends early")


def test_missing_eoi_reads(tmp_path, example):
    """All scan data present but no EOI: cv2's image (libjpeg only warns)."""
    _check(tmp_path, _encode(example[:60, :90], 90, "420")[:-2])


def _patched_sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    out = bytearray(data)
    for m, s, _ in _segments(data):
        if m in (0xC0, 0xC2):
            if marker is not None:
                out[s + 1] = marker
            if precision is not None:
                out[s + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("marker,match", [
    (0xC9, "arithmetic coding"), (0xCA, "arithmetic coding"), (0xC3, "lossless"),
    (0xC5, "hierarchical"),
])
def test_unsupported_coding_raises(tmp_path, example, marker, match):
    """A hand-built SOF9/10 (arithmetic), SOF3 (lossless) or SOF5 header."""
    _expect_refused(tmp_path, _patched_sof(_encode(example[:40, :40], 90, "420"), marker), match)


def test_twelve_bit_and_cmyk_raise(tmp_path, example):
    from PIL import Image

    _expect_refused(tmp_path, _patched_sof(_encode(example[:40, :40], 90, "420"), precision=12),
                    "12-bit")
    buf = io.BytesIO()
    Image.fromarray(example[:40, :60, ::-1]).convert("CMYK").save(buf, "JPEG")
    path = tmp_path / "cmyk.jpg"
    path.write_bytes(buf.getvalue())
    assert cv2.imread(str(path)) is not None  # cv2 converts CMYK; the port refuses it
    _expect_refused(tmp_path, buf.getvalue(), "CMYK")


def test_other_formats_raise_naming_the_file(tmp_path, example):
    """A TIFF raises, naming the file (a BMP is read: tests/test_torch_bmp.py)."""
    tiff = tmp_path / "shot.tiff"
    cv2.imwrite(str(tiff), example[:8, :8])
    with pytest.raises(ValueError, match="shot.tiff: not a PNG, JPEG or BMP"):
        imread_bgr(str(tiff))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00")
    with pytest.raises(ValueError, match="bad.jpg: .*(no frame header|truncated)"):
        imread_bgr(str(bad))
    with pytest.raises(FileNotFoundError):
        imread_bgr(str(tmp_path / "missing.jpg"))


def test_decoder_runs_in_threads(tmp_path, example):
    """Four threads decode at once (the call releases the interpreter lock;
    the decoder shares only a constant table): each gets cv2's bytes."""
    datas = [_encode(example[:300, :400], q, s) for q, s in ((60, "420"), (90, "444"),
                                                             (75, "422"), (95, "411"))]
    refs = [cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_COLOR) for d in datas]
    got, errors = [None] * 4, []

    def run(i):
        try:
            for _ in range(5):
                got[i], _ = native.jpeg_decode(datas[i])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    for g, r in zip(got, refs):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("name", sorted(cases.FIXTURE_SPECS))
def test_committed_fixtures_and_hashes_match_cv2(name):
    """Each committed fixture decodes to cv2's bytes, and cv2_decode.json
    (which chip_smoke.py reads on the card's host) holds cv2's hash."""
    path = os.path.join(cases.FIXTURES, name)
    ref = cv2.imread(path)
    got = imread_bgr(path)
    np.testing.assert_array_equal(got, ref)
    entry = cases.load_hashes()["files"][name]
    assert entry["sha256"] == hashlib.sha256(ref.tobytes()).hexdigest() == cases.sha256_of(got)
    assert entry["shape"] == list(ref.shape)


# --- the loaders over JPEG files, against the JAX package --------------------


def test_file_source_over_jpegs_matches_jax(tmp_path, example):
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"f{i}.jpg"), np.roll(example, 7 * i, axis=1)[:90, :160])
    cv2.imwrite(str(tmp_path / "f3.png"), example[:90, :160])
    got = list(pt_capture.file_source(str(tmp_path)))
    ref = list(jax_capture.file_source(str(tmp_path)))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_load_classify_folder_over_jpegs_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    for c, sizes in (("a", [(64, 64), (30, 22)]), ("b", [(33, 97), (120, 64), (41, 41)])):
        os.makedirs(tmp_path / c)
        for i, (h, w) in enumerate(sizes):
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            ext, params = ((".jpg", [cv2.IMWRITE_JPEG_QUALITY, 80]) if i % 2 == 0
                           else (".jpeg", [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]))
            cv2.imwrite(str(tmp_path / c / f"{i}{ext}"), img, params)
    got = pt_data.load_classify_folder(str(tmp_path), 64)
    ref = jax_data.load_classify_folder(str(tmp_path), 64)
    assert got[2] == ref[2] == ["a", "b"]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])


def _jpeg_yolo_root(root, example):
    """A YOLO split of JPEG screenshots (crops of the example) with labels."""
    rng = np.random.default_rng(11)
    for split in ("train", "valid"):
        os.makedirs(os.path.join(root, split, "images"))
        os.makedirs(os.path.join(root, split, "labels"))
    stems = []
    for i, (y, x) in enumerate(((0, 0), (300, 500), (500, 900))):
        img = example[y:y + 360, x:x + 640]
        stem = f"shot{i}_png.rf.{i:04x}"
        cv2.imwrite(os.path.join(root, "train", "images", stem + ".jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 85])
        rows = []
        for _ in range(4):
            w, h = rng.uniform(0.03, 0.08), rng.uniform(0.05, 0.12)
            rows.append(f"{int(rng.integers(0, 13))} {rng.uniform(0.1, 0.9):.6f} "
                        f"{rng.uniform(0.1, 0.9):.6f} {w:.6f} {h:.6f}")
        with open(os.path.join(root, "train", "labels", stem + ".txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        stems.append(stem)
    return stems


def test_load_yolo_split_over_jpegs_matches_jax(tmp_path, example):
    root = str(tmp_path / "ds")
    _jpeg_yolo_root(root, example)
    for max_side in (None, 400):
        got = pt_data.load_yolo_split(root, "train", max_side)
        ref = jax_data.load_yolo_split(root, "train", max_side)
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.image, r.image)
            np.testing.assert_array_equal(g.boxes, r.boxes)
            np.testing.assert_array_equal(g.classes, r.classes)


def test_build_matched_rank_dataset_matches_jax(tmp_path, example, capsys):
    """Crops re-cut from the JPEG screenshots through the crop function, on a
    rank folder whose names encode (screenshot, class, label row): the same
    labels, names and jitter draws as the JAX package, crops within 1 LSB
    (the two frameworks' f32 bilinear gathers may round a sample apart); the
    unmappable names (no parse, no such row, no screenshot) are skipped and
    counted as in JAX."""
    det_root = str(tmp_path / "det")
    stems = _jpeg_yolo_root(det_root, example)
    rank_root = tmp_path / "rank"
    with open(os.path.join(det_root, "train", "labels", "noshot.txt"), "w") as f:
        f.write("3 0.5 0.5 0.05 0.08\n")
    names = {"train": [(stems[0], 0, "2"), (stems[0], 3, "A"), (stems[1], 1, "2"),
                       (stems[2], 2, "K"), (stems[2], 9, "K"), ("gone", 0, "A"),
                       ("noshot", 0, "K")],
             "valid": [(stems[1], 2, "A"), (stems[2], 0, "K")]}
    for split, items in names.items():
        for stem, row, cls in items:
            os.makedirs(rank_root / split / cls, exist_ok=True)
            cv2.imwrite(str(rank_root / split / cls / f"{stem}_flop1_rank_{row}.jpg"),
                        np.zeros((20, 14, 3), np.uint8))
        (rank_root / split / "A" / "notes.jpg").write_bytes(b"")
    differ = []
    for split, jitter in (("train", 2), ("valid", 0)):
        got = pt_matched.build_matched_rank_dataset(str(rank_root), det_root, split,
                                                    jitter=jitter, seed=3, device="cpu")
        out_pt = capsys.readouterr().out
        ref = jax_matched.build_matched_rank_dataset(str(rank_root), det_root, split,
                                                     jitter=jitter, seed=3)
        out_jax = capsys.readouterr().out
        assert out_pt == out_jax and "skipped" in out_pt
        assert got[2] == ref[2]
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[0].dtype == ref[0].dtype == np.uint8 and got[0].shape == ref[0].shape
        diff = np.abs(got[0].astype(int) - ref[0].astype(int))
        assert diff.max() <= 1
        differ.append(int((diff > 0).sum()))
    assert len(got[1]) == 2
    # crop bytes that differ by one LSB: 1 of the train split's 36,864 (12
    # crops), none of the valid split's, on the machine that wrote this test
    print(f"bytes that differ (train, valid): {differ}")
    assert differ[0] <= 4 and differ[1] <= 4
