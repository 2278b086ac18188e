"""The JAX package's random draws, replayed from its keys as the noise
dicts of ``tpu3dlm_torch/ops/augment.py`` (and the sampled batch indices
of the YOLO step), so the port's deterministic applies can be fed the
reference's noise. Each function walks the key tree of the reference
function it names, call for call."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

DET = dict(hflip_p=0.5, brightness=0.2, contrast=0.2, zoom_p=0.5, zoom_min=0.7, erase_p=0.0,
           erase_count=2, erase_max=0.35)
CROP = dict(gain_lo=0.4, gain_hi=1.8, offset=25.0, hflip_p=0.5, erase_p=0.5, erase_max=0.45)


def _erase_one(key, max_frac):
    """``tpu3dlm/ops/augment.py::_erase_one``'s draws."""
    kx, ky, kw, kh, kc = jax.random.split(key, 5)
    return {
        "erase_w": jax.random.uniform(kw, (), minval=0.08, maxval=max_frac),
        "erase_h": jax.random.uniform(kh, (), minval=0.08, maxval=max_frac),
        "erase_x": jax.random.uniform(kx, ()),
        "erase_y": jax.random.uniform(ky, ()),
        "erase_color": jax.random.uniform(kc, (3,)),
    }


def _detection_one(key, o):
    """``_augment_one``'s draws (its ``_hflip``, ``_color_jitter``,
    ``_crop_zoom`` and ``_erase``)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    kb, kc = jax.random.split(k2)
    kd, kz, kx, ky = jax.random.split(k3, 4)
    out = {
        "flip": jax.random.bernoulli(k1, o["hflip_p"]),
        "brightness": jax.random.uniform(kb, (), minval=-o["brightness"], maxval=o["brightness"]),
        "contrast": jax.random.uniform(kc, (), minval=1.0 - o["contrast"], maxval=1.0 + o["contrast"]),
        "zoom": jax.random.bernoulli(kd, o["zoom_p"]),
        "zoom_scale": jax.random.uniform(kz, (), minval=o["zoom_min"], maxval=1.0),
        "zoom_x": jax.random.uniform(kx, ()),
        "zoom_y": jax.random.uniform(ky, ()),
    }
    if o["erase_p"] > 0.0:
        patches, key = [], k4
        for i in range(o["erase_count"]):
            kd, ke, key = jax.random.split(jax.random.fold_in(key, i), 3)
            patches.append({"erase": jax.random.bernoulli(kd, o["erase_p"]),
                            **_erase_one(ke, o["erase_max"])})
        out.update({k: jnp.stack([p[k] for p in patches]) for k in patches[0]})
    return out


def _stack(per: list) -> dict:
    return {k: torch.from_numpy(np.stack([np.array(p[k]) for p in per])) for k in per[0]}


def detection_noise(key, n: int, **kw) -> dict:
    """``augment_detection_batch(key, ...)``'s noise for ``n`` images."""
    o = {**DET, **kw}
    return _stack([_detection_one(k, o) for k in jax.random.split(key, n)])


def crop_noise(key, n: int, **kw) -> dict:
    """``augment_crop_batch(key, ...)``'s noise for ``n`` crops."""
    o = {**CROP, **kw}
    per = []
    for k in jax.random.split(key, n):
        kg, ko, kf, ke, kd = jax.random.split(k, 5)
        per.append({
            "gain": jnp.exp(jax.random.uniform(kg, (), minval=jnp.log(o["gain_lo"]),
                                               maxval=jnp.log(o["gain_hi"]))),
            "offset": jax.random.uniform(ko, (), minval=-o["offset"], maxval=o["offset"]),
            "flip": jax.random.bernoulli(kf, o["hflip_p"]),
            "erase": jax.random.bernoulli(kd, o["erase_p"]),
            **_erase_one(ke, o["erase_max"]),
        })
    return _stack(per)


def yolo_step_noise(key, n_frames: int, augment: dict, sample_batch: int | None = None, rank: int = 0,
                    n_dev: int = 1) -> dict:
    """One ``make_yolo_train_step`` step's draws for shard ``rank`` of an
    ``n_dev``-device mesh (``n_frames`` the shard's frames): the key folded
    with the shard, the sampled frames (``batch_idx``, ``sample_batch //
    n_dev`` of them) when ``sample_batch``, then the detection noise of the
    batch."""
    key = jax.random.fold_in(key, rank)
    out = {}
    if sample_batch is not None:
        sample_batch = max(1, sample_batch // n_dev)
        ks, key = jax.random.split(key)
        idx = jax.random.choice(ks, n_frames, (sample_batch,), replace=False)
        out["batch_idx"] = torch.from_numpy(np.asarray(idx).astype(np.int64))
        n_frames = sample_batch
    out.update(detection_noise(key, n_frames, **augment))
    return out


def beit_step_noise(key, n_crops: int, augment: dict, rank: int = 0) -> dict:
    """One ``make_beit_train_step(augment=...)`` step's draws for shard
    ``rank`` (``n_crops`` the shard's crops)."""
    return crop_noise(jax.random.fold_in(key, rank), n_crops, **augment)


def finetune_keys(seed: int, steps: int) -> list:
    """The per-step keys of ``finetune_yolo`` / ``finetune_beit``."""
    base = jax.random.PRNGKey(seed + 1)
    return [jax.random.fold_in(base, i) for i in range(steps)]
