"""Synthetic-text CRNN training. Counterpart of ``manual_yolo_tpu/train/ocr.py``.

The recognizer learns from renders of the string distributions the runtime
reads (amounts, names, game ids, cards, generic text), with the JAX
package's photometric jitter, noise, blur, chip glyphs, down-up scaling,
JPEG round trips and edge cuts, and optionally from labelled real crops.

For one ``np.random.default_rng(seed)`` the samplers, ``render_text``,
``make_batch`` and ``build_pool`` give the JAX package's strings and
arrays: text is drawn from the committed glyph table
(``runtime/truetype.py``, PIL's layout and FreeType's bitmaps of the DejaVu
fonts), the JPEG round trip goes through ``runtime/jpeg.py`` (cv2's bytes),
the area resize is cv2's (``ops/image.py::cv_resize_area``). The float
linear and cubic resizes are ``ops/image.py::cv_resize``, equal to cv2 to
within f32 rounding.

A train step (f32; the JAX trainer's ``compute_dtype`` is not ported, as
its CLI never sets it) gathers a batch from the uint8 pool resident on the
device, runs the CRNN forward, the CTC loss averaged over the batch (optax's
``ctc_loss`` then the mean: not torch's ``"mean"``, which divides by the
target lengths), clips the gradient to a global norm of 5 and takes an
AdamW step with optax's defaults (weight decay 1e-4 on every parameter)
over the warmup-cosine schedule. The host index draws use the JAX
trainer's chunk shapes, so one seed gives the same batches. Real crops get
the JAX trainer's photometric jitter from a ``torch.Generator`` on the
device (the JAX package draws it from ``jax.random``: the same
distributions, not the same numbers).
"""

from __future__ import annotations

import contextlib
import os
import string
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from manual_yolo_tpu_torch.core.device import cudnn_enabled, full_f32, resolve_device
from manual_yolo_tpu_torch.core.serialization import load_params, save_params
from manual_yolo_tpu_torch.models import crnn
from manual_yolo_tpu_torch.ops.ctc import decode_to_text, greedy_decode
from manual_yolo_tpu_torch.ops.image import cv_resize, cv_resize_area
from manual_yolo_tpu_torch.runtime import truetype
from manual_yolo_tpu_torch.runtime.jpeg import encode_jpeg
from manual_yolo_tpu_torch.runtime.native import jpeg_decode
from manual_yolo_tpu_torch.train.optim import adamw, clip_by_global_norm, set_lr, warmup_cosine

# the JAX package's font paths; runtime/truetype.py looks up their base names
FONTS = [
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSerif-Bold.ttf",
]
WEIGHT_DECAY = 1e-4  # optax.adamw's default
CLIP_NORM = 5.0


def random_amount(rng) -> str:
    style = rng.integers(0, 9)
    if style == 0:
        return str(rng.integers(1, 1_000_000))
    if style == 1:
        return f"{rng.integers(1, 1000)}.{rng.integers(0, 10)}K"
    if style == 2:
        v = rng.integers(1000, 10_000_000)
        s = f"{v:,}"
        return ("$" + s) if rng.random() < 0.5 else s
    if style == 3:
        return f"{rng.integers(0, 100)}.{rng.integers(0, 100):02d}"
    if style == 4:
        return f"{rng.integers(1, 100)}.{rng.integers(0, 10)}M"
    # UI styles of real crops: plain K, lakh, big-blind denominations, zero
    if style == 5:
        return f"{rng.integers(1, 100)}K"
    if style == 6:
        return f"{rng.integers(1, 10)}.{rng.integers(0, 100):02d}L".replace(".00", "")
    if style == 7:
        v = rng.random()
        if v < 0.33:
            return f"{rng.integers(1, 250)}BB"
        if v < 0.66:
            return f"{rng.integers(0, 100)}.{rng.integers(1, 10)}BB"
        return f"{rng.integers(1, 3)}.{rng.integers(0, 100):02d}KBB"
    return "0"


_NAME_WORDS = [
    "Solemn", "Influx", "Cloudy", "Comb", "Chrome", "Green", "Alpine",
    "Noyes", "Sacred", "Firme", "Skyborn", "Graft", "Inner", "Italic",
    "Secret", "Cutler", "Auburn", "Insight", "Iron", "Contest", "Dream",
    "Fiddle", "Flaming", "Lizard", "Angsty", "Modish", "Darker", "Joyful",
    "Quiet", "Homer", "Deadly", "Fearer", "August", "Mesmer", "Mortal",
    "Issue", "Cruel", "Goof", "Wild", "Lariat", "Dark", "Bower", "Bronze",
    "Nuance", "grid", "iron", "sport", "fire", "time", "money", "ball",
    "snow", "speed", "cube", "game", "goal", "fer", "climber", "acrobat",
    "basket", "berserker", "unifight", "turumchi", "ruata", "vk", "fp",
]


def random_name(rng) -> str:
    """CamelCase pairs, lowercase word + digits, dotted, plain random; some
    with a doubled character or the UI's truncation ellipsis."""
    style = rng.random()
    if style < 0.35:
        w = _NAME_WORDS[rng.integers(0, len(_NAME_WORDS))].capitalize()
        w2 = _NAME_WORDS[rng.integers(0, len(_NAME_WORDS))].capitalize()
        s = w + w2
        if rng.random() < 0.4:
            s += str(rng.integers(0, 1000))
    elif style < 0.6:
        w = _NAME_WORDS[rng.integers(0, len(_NAME_WORDS))].lower()
        w2 = _NAME_WORDS[rng.integers(0, len(_NAME_WORDS))].lower()
        s = w + (w2 if rng.random() < 0.5 else "") + str(rng.integers(0, 100000))
    elif style < 0.7:
        w = _NAME_WORDS[rng.integers(0, len(_NAME_WORDS))].lower()
        s = string.ascii_lowercase[rng.integers(0, 26)] + "." + w
    else:
        n = int(rng.integers(2, 14))
        chars = string.ascii_letters + string.digits + "_"
        s = "".join(chars[rng.integers(0, len(chars))] for _ in range(n))
    # doubled characters: where greedy CTC drops glyphs, so oversampled
    if rng.random() < 0.12:
        i = int(rng.integers(0, len(s)))
        s = s[: i + 1] + s[i] + s[i + 1:]
    if len(s) >= 10 and rng.random() < 0.45:
        s = s[: rng.integers(8, min(len(s), 13))] + "..."
    return s[:24]


def random_game_id(rng) -> str:
    r = rng.random()
    if r < 0.45:
        return f"Game ID : {rng.integers(232000000, 233000000)}"
    if r < 0.7:
        return str(rng.integers(1000, 10_000_000))
    return "Game_" + "".join(
        string.ascii_uppercase[rng.integers(0, 26)] for _ in range(2)
    ) + str(rng.integers(10, 100))


def random_card(rng) -> str:
    ranks = ["A", "K", "Q", "J", "T", "10", "2", "3", "4", "5", "6", "7", "8", "9"]
    suits = ["s", "h", "d", "c", "S", "H", "D", "C"]
    return ranks[rng.integers(0, len(ranks))] + suits[rng.integers(0, len(suits))]


def random_sample(rng, kinds: Optional[frozenset] = None) -> Tuple[str, str]:
    """-> (label, unlabeled suffix). The suffix (a chip and a side-pot amount)
    is rendered after the label but is not part of the CTC target. ``kinds``
    (None = all) keeps only those field kinds, by rejection."""
    while True:
        kind, out = _random_sample_once(rng)
        if kinds is None or kind in kinds:
            return out


def _random_sample_once(rng) -> Tuple[str, Tuple[str, str]]:
    r = rng.random()
    if r < 0.40:
        amt = random_amount(rng)
        pre = rng.random()
        if pre < 0.18:
            amt = ("Pot:" if pre < 0.12 else "Pot: ") + amt
        suffix = random_amount(rng) if rng.random() < 0.30 else ""
        return "numeric", (amt, suffix)
    if r < 0.65:
        return "name", (random_name(rng), "")
    if r < 0.80:
        return "game_id", (random_game_id(rng), "")
    if r < 0.92:
        return "card", (random_card(rng), "")
    t = "".join(
        crnn.CHARSET[rng.integers(1, len(crnn.CHARSET))] for _ in range(rng.integers(1, 10))
    ).strip() or "0"
    return "generic", (t, "")


def _draw_chip(rng, arr: np.ndarray, cx: int, cy: int, rad: int) -> None:
    """Poker-chip glyph: bright disc, darker inner ring, centre dot."""
    h, w = arr.shape
    ys, xs = np.ogrid[:h, :w]
    d2 = (ys - cy) ** 2 + (xs - cx) ** 2
    outer = float(rng.uniform(0.6, 1.0))
    arr[d2 <= rad**2] = outer
    r2 = max(rad - 2, 1)
    arr[d2 <= r2**2] = float(rng.uniform(0.1, 0.4))
    r3 = max(rad // 2, 1)
    arr[d2 <= r3**2] = outer


def jpeg_round_trip_gray(arr: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode(".jpg", u8, [quality])[1], IMREAD_GRAYSCALE)``
    of a 2-D f32 image in [0, 1], as f32 in [0, 1]."""
    u8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    img, _ = jpeg_decode(encode_jpeg(u8, quality))
    return img[..., 0].astype(np.float32) / 255.0


def render_text(
    rng, text: str, target_w: int, suffix: str = "", img_h: int = crnn.IMG_H
) -> np.ndarray:
    """Render to an (img_h, target_w) float image in [0, 1] with augmentation;
    ``suffix`` is drawn after the text, beyond a chip glyph."""
    size = int(rng.integers(18, 30))
    font = truetype.truetype(FONTS[rng.integers(0, len(FONTS))], size)

    pad = int(rng.integers(2, 8))
    gap = int(rng.integers(size, 2 * size)) if suffix else 0
    bbox = font.getbbox(text)
    tw = max(1, bbox[2] - bbox[0])
    th = max(1, bbox[3] - bbox[1])
    sw = 0
    if suffix:
        sb = font.getbbox(suffix)
        sw = max(1, sb[2] - sb[0])
    canvas_w = tw + sw + gap + 2 * pad
    img = np.full((th + 2 * pad, canvas_w), 255, np.uint8)
    truetype.draw_text(img, (pad - bbox[0], pad - bbox[1]), text, font, 0)
    if suffix:
        truetype.draw_text(img, (pad + tw + gap - sb[0], pad - bbox[1]), suffix, font, 0)

    if rng.random() < 0.3:
        img = truetype.gaussian_blur(img, float(rng.random()) * 1.2)
    arr = img.astype(np.float32) / 255.0
    # poker UIs are mostly light text on dark chrome: bias polarity flips
    if rng.random() < 0.55:
        arr = 1.0 - arr
    # UI-chrome panel border: light horizontal rule at top/bottom edges
    if rng.random() < 0.3:
        edge = float(rng.uniform(0.5, 1.0))
        if rng.random() < 0.7:
            arr[0: int(rng.integers(1, 3))] = edge
        if rng.random() < 0.7:
            arr[-int(rng.integers(1, 3)):] = edge
    arr = np.clip(arr * rng.uniform(0.6, 1.2) + rng.uniform(-0.15, 0.25), 0, 1)
    if rng.random() < 0.5:
        arr = np.clip(arr + rng.normal(0, rng.uniform(0.01, 0.07), arr.shape), 0, 1)
    # chip glyph between text and suffix, else sometimes at either edge
    h, w = arr.shape
    if suffix:
        frac = (pad + tw + gap // 2) / max(canvas_w, 1)
        _draw_chip(rng, arr, int(frac * w), h // 2, int(rng.integers(h // 3, h // 2)))
    elif rng.random() < 0.2:
        cx = int(rng.integers(0, max(w // 5, 1))) if rng.random() < 0.5 else (
            w - 1 - int(rng.integers(0, max(w // 5, 1)))
        )
        _draw_chip(rng, arr, cx, h // 2 + int(rng.integers(-3, 4)),
                   int(rng.integers(3, max(h // 2, 4))))
    # small-text degradation: down then up (blurry far-away fields)
    if rng.random() < 0.4:
        sh = int(rng.integers(12, 26))
        sw2 = max(8, int(w * sh / h))
        small = cv_resize_area(arr, (sh, sw2))
        arr = cv_resize(small, (h, w), cubic=not rng.random() < 0.7)
    # JPEG artifacts: the reference dataset's images are JPEG files
    if rng.random() < 0.5:
        arr = jpeg_round_trip_gray(arr, int(rng.integers(35, 90)))
    # random edge clipping (tight detector boxes cut glyph edges)
    if rng.random() < 0.3:
        h, w = arr.shape
        cut = int(rng.integers(1, max(w // 12, 2)))
        arr = arr[:, cut:] if rng.random() < 0.5 else arr[:, : w - cut]
    return crnn.preprocess_gray(arr, target_w, img_h=img_h)


@dataclass
class OCRTrainConfig:
    out_path: str = "weights/crnn_synth.npz"
    steps: int = 6000
    batch: int = 64
    width: int = 256
    # input canvas height: 32 canonical, 64 the high-resolution member
    img_h: int = crnn.IMG_H
    max_label: int = 28
    lr: float = 1e-3
    hidden: int = 256
    seed: int = 0
    eval_every: int = 500
    pool_size: int = 20000  # pre-rendered sample pool
    # real labelled crops (data/ocr_real/labels.json) mixed into batches at
    # real_frac, from real_splits only, so held-out splits stay eval-only
    real_labels: str = ""
    real_splits: Tuple[str, ...] = ("valid",)
    real_frac: float = 0.35
    # warm start from a checkpoint of the same geometry
    init_from: str = ""
    # comma-separated field kinds to specialise on (written into the meta)
    kinds: str = ""
    device: str = "cuda"

    def kind_set(self) -> Optional[frozenset]:
        return frozenset(k for k in self.kinds.split(",") if k) or None


def _encode_label(t: str, max_label: int):
    ids = [crnn.char_to_id(c) for c in t][:max_label]
    labels = np.zeros(max_label, np.int32)
    lab_pad = np.ones(max_label, np.float32)
    labels[: len(ids)] = ids
    lab_pad[: len(ids)] = 0.0  # 0 = valid, as optax.ctc_loss takes it
    return labels, lab_pad


def build_pool(rng, cfg: OCRTrainConfig, size: int):
    """``size`` rendered samples: (imgs (size, img_h, width, 1), labels,
    label paddings, texts)."""
    imgs = np.zeros((size, cfg.img_h, cfg.width, 1), np.float32)
    labels = np.zeros((size, cfg.max_label), np.int32)
    lab_pad = np.ones((size, cfg.max_label), np.float32)
    texts = []
    kinds = cfg.kind_set()
    for i in range(size):
        t, suffix = random_sample(rng, kinds)
        t = t[: cfg.max_label]
        texts.append(t)
        imgs[i, :, :, 0] = render_text(rng, t, cfg.width, suffix, cfg.img_h)
        labels[i], lab_pad[i] = _encode_label(t, cfg.max_label)
    return imgs, labels, lab_pad, texts


def make_batch(rng, cfg: OCRTrainConfig):
    """One batch of fresh renders, as ``build_pool`` of ``cfg.batch``."""
    return build_pool(rng, cfg, cfg.batch)


def load_real_pool(cfg: OCRTrainConfig):
    """Labelled real crops of ``cfg.real_splits`` -> (gray (N, img_h, W),
    labels, label paddings); characters outside the charset are dropped."""
    from manual_yolo_tpu_torch.cli.eval_ocr import load_real_crops
    from manual_yolo_tpu_torch.runtime.ocr import OCREngine, field_kind

    kinds = cfg.kind_set()
    grays, labels, pads = [], [], []
    for crop, cname, truth in load_real_crops(cfg.real_labels, splits=tuple(cfg.real_splits)):
        if kinds is not None and field_kind(cname) not in kinds:
            continue
        grays.append(crnn.preprocess_gray(OCREngine._to_gray(crop), cfg.width, img_h=cfg.img_h))
        t = "".join(c for c in truth if c in crnn.CHARSET)[: cfg.max_label]
        lab, pad = _encode_label(t, cfg.max_label)
        labels.append(lab)
        pads.append(pad)
    return np.stack(grays), np.stack(labels), np.stack(pads)


def pool_u8(imgs_f32: np.ndarray, device) -> torch.Tensor:
    """A (N, ...) float [0, 1] image pool quantised to uint8 on ``device``, as
    the JAX trainer keeps it resident: ``clip(x * 255 + 0.5)``."""
    u8 = np.clip(imgs_f32 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return torch.from_numpy(u8).to(device)


def augment_real(gen: torch.Generator, imgs: torch.Tensor) -> torch.Tensor:
    """The JAX trainer's gentle jitter of real crops (N, H, W): gain in
    [0.8, 1.2), bias in [-0.1, 0.1), N(0, 0.03) noise on 30% of them, then
    clipped, and 25% inverted; drawn from ``gen`` on the crops' device."""
    n, dev = imgs.shape[0], imgs.device
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    gain = u(n, 1, 1) * 0.4 + 0.8
    bias = u(n, 1, 1) * 0.2 - 0.1
    out = imgs * gain + bias
    noise = torch.randn(imgs.shape, generator=gen, device=dev) * 0.03
    out = out + torch.where(u(n, 1, 1) < 0.3, noise, 0.0)
    out = torch.clamp(out, 0.0, 1.0)
    return torch.where(u(n, 1, 1) < 0.25, 1.0 - out, out)


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, lab_pad: torch.Tensor) -> torch.Tensor:
    """Per-sample CTC negative log-likelihood, as ``optax.ctc_loss(logits,
    zeros, labels, lab_pad)``: logits (N, T, C) with blank 0, labels (N, L)
    valid where ``lab_pad`` is 0."""
    logits = logits if logits.dtype == torch.float64 else logits.float()
    logp = F.log_softmax(logits, dim=-1).transpose(0, 1)  # (T, N, C)
    n, t = logits.shape[:2]
    lens = (lab_pad < 0.5).sum(dim=1)
    return F.ctc_loss(logp, labels.long(), torch.full((n,), t, dtype=torch.long, device=logits.device),
                      lens.long(), blank=crnn.BLANK, reduction="none", zero_infinity=False)


def step_numerics(device: torch.device):
    """The numerics of an f32 train step's forward and backward: TF32 off,
    and on the card the convs without cuDNN. With TF32 off cuDNN takes FFT
    algorithms for these convs (the profiled step's top kernels), whose
    first gradients measured 2-4% of each leaf's largest away from f64 on
    an H100, against 2.5e-4 for the CPU's f32 and for the card's convs
    without cuDNN. The LSTM keeps cuDNN's RNN (``models/crnn.py``)."""
    stack = contextlib.ExitStack()
    stack.enter_context(full_f32())
    stack.enter_context(cudnn_enabled(device.type != "cuda"))
    return stack


def ocr_step(model, opt, params: List[torch.Tensor], imgs: torch.Tensor, labels: torch.Tensor,
             lab_pad: torch.Tensor, lr: float) -> torch.Tensor:
    """One f32 train step on (N, H, W) images in [0, 1]; returns the mean loss."""
    with step_numerics(imgs.device):
        loss = ctc_loss(model(imgs[..., None]), labels, lab_pad).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
    clip_by_global_norm([p.grad for p in params], CLIP_NORM)
    set_lr(opt, lr)
    opt.step()
    return loss.detach()


@torch.no_grad()
def read_texts(model, imgs: torch.Tensor) -> List[str]:
    """Greedy reads of (N, H, W) images in [0, 1]."""
    ids, _conf = greedy_decode(model(imgs[..., None]))
    return [decode_to_text(row) for row in ids.cpu().numpy()]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_ocr(cfg: OCRTrainConfig, log=print) -> Dict:
    """Returns the JAX trainer's ``best_exact`` and ``wall_s``, plus ``pool_s``
    (the render) and ``history``: per eval the step, loss, exact match,
    real holdout and the seconds spent in train steps so far."""
    dev = resolve_device(cfg.device)
    rng = np.random.default_rng(cfg.seed)
    params = crnn.init_params(torch.Generator().manual_seed(cfg.seed), cfg.hidden)
    if cfg.init_from:
        init, imeta = load_params(cfg.init_from)
        shapes = lambda tree: [np.shape(tree[k][n]) for k in sorted(tree) for n in sorted(tree[k])]  # noqa: E731
        if shapes(init) != shapes(params):
            raise ValueError(f"init_from {cfg.init_from} geometry mismatch: {imeta}")
        params = init
        log(f"warm-start from {cfg.init_from} ({imeta})")
    model = crnn.for_training(crnn.from_jax_params(params, dev).train())
    trainable = [p for p in model.parameters() if p.requires_grad]
    sched = warmup_cosine(cfg.lr * 0.05, cfg.lr, min(300, cfg.steps // 5), cfg.steps, cfg.lr * 0.02)
    opt = adamw(trainable, WEIGHT_DECAY)

    t0 = time.time()
    log(f"rendering {cfg.pool_size}-sample pool...")
    p_imgs, p_labels, p_pad, _texts = build_pool(rng, cfg, cfg.pool_size)
    pool_s = time.time() - t0
    log(f"pool ready in {pool_s:.0f}s")

    r_imgs = rh_imgs = rh_labels = None
    if cfg.real_labels and os.path.exists(cfg.real_labels):
        a_imgs, a_labels, a_pad = load_real_pool(cfg)
        # hold out ~15% of the real pool for checkpoint selection
        hsplit = np.arange(len(a_imgs)) % 7 == 0
        rh_imgs, rh_labels = a_imgs[hsplit], a_labels[hsplit]
        r_imgs, r_labels, r_pad = a_imgs[~hsplit], a_labels[~hsplit], a_pad[~hsplit]
        log(f"real pool: {len(r_imgs)} train + {len(rh_imgs)} holdout crops "
            f"from splits {cfg.real_splits}")

    # resident device pools: uint8 pixels, exact labels and paddings
    d_pool = pool_u8(p_imgs[..., 0], dev)
    d_labels, d_pad = torch.from_numpy(p_labels).to(dev), torch.from_numpy(p_pad).to(dev)
    have_real = r_imgs is not None and cfg.real_frac > 0 and len(r_imgs) > 0
    k_real = int(cfg.batch * cfg.real_frac) if have_real else 0
    if have_real:
        d_rpool = pool_u8(r_imgs, dev)
        d_rlabels, d_rpad = torch.from_numpy(r_labels).to(dev), torch.from_numpy(r_pad).to(dev)
    d_hold = pool_u8(rh_imgs, dev) if rh_imgs is not None and len(rh_imgs) else None
    aug_gen = torch.Generator(device=dev).manual_seed(cfg.seed)

    def exact_match() -> float:
        imgs, _labels, _pad, texts = make_batch(rng, cfg)
        got = read_texts(model.eval(), torch.from_numpy(imgs[..., 0]).to(dev))
        model.train()
        return sum(g == t for g, t in zip(got, texts)) / len(texts)

    chunk = max(1, cfg.eval_every // 4)
    best_acc, history, train_s = 0.0, [], 0.0
    s = 0
    loss = torch.zeros(())
    while s < cfg.steps:
        n = min(chunk, cfg.steps - s)
        sidx = rng.integers(0, cfg.pool_size, (n, cfg.batch)).astype(np.int32)
        ridx = (rng.integers(0, len(r_imgs), (n, max(k_real, 1))).astype(np.int32)
                if have_real else np.zeros((n, 1), np.int32))
        d_sidx, d_ridx = torch.from_numpy(sidx).long().to(dev), torch.from_numpy(ridx).long().to(dev)
        ts = time.perf_counter()
        for j in range(n):
            idx = d_sidx[j]
            imgs = d_pool[idx].float() / 255.0
            labels, lab_pad = d_labels[idx], d_pad[idx]
            if k_real:
                ridx1 = d_ridx[j]
                rimgs = augment_real(aug_gen, d_rpool[ridx1].float() / 255.0)
                imgs = torch.cat([rimgs, imgs[k_real:]])
                labels = torch.cat([d_rlabels[ridx1], labels[k_real:]])
                lab_pad = torch.cat([d_rpad[ridx1], lab_pad[k_real:]])
            loss = ocr_step(model, opt, trainable, imgs, labels, lab_pad, sched(s + j))
        _sync(dev)
        train_s += time.perf_counter() - ts
        s += n
        if s % cfg.eval_every == 0 or s >= cfg.steps:
            acc = exact_match()
            real_acc = None
            if d_hold is not None:
                got = read_texts(model.eval(), d_hold.float() / 255.0)
                model.train()
                want = ["".join(crnn.CHARSET[c - 1] for c in row if c > 0) for row in rh_labels]
                real_acc = sum(g == w for g, w in zip(got, want)) / len(want)
            # selection: the worse of synthetic and real holdout
            score = acc if real_acc is None else min(acc, real_acc)
            history.append({"step": s, "ctc": float(loss), "exact": acc,
                            "real_holdout": real_acc, "train_s": train_s})
            log(f"step {s}/{cfg.steps} ctc {float(loss):.3f} exact {acc:.3f}"
                + (f" real_holdout {real_acc:.3f}" if real_acc is not None else "")
                + f" ({time.time()-t0:.0f}s)")
            if score >= best_acc:
                best_acc = score
                meta = {"hidden": cfg.hidden, "width": cfg.width,
                        "img_h": cfg.img_h, "exact_match": acc, "step": s}
                if real_acc is not None:
                    meta["real_holdout"] = real_acc
                if cfg.kinds:
                    meta["kinds"] = cfg.kinds
                save_params(cfg.out_path, crnn.to_jax_params(model), meta=meta)
    return {"best_exact": best_acc, "wall_s": time.time() - t0, "pool_s": pool_s,
            "history": history}
