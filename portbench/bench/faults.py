"""Faults planted under the timed path, each a function of a patcher with
pytest's ``monkeypatch.setattr``: the tests plant them at toy size, and
``control.py --faults`` at the cell's own size, for the readings the
training cell's limits are held against.  ``FAULTS[cell]``: the faults
that cell can have (none crosses chips here: every cell takes one)."""

from __future__ import annotations

import contextlib

import torch


class Patcher:
    """``setattr`` that ``undo`` puts back."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved = []


@contextlib.contextmanager
def planted(fault):
    patcher = Patcher()
    fault(patcher)
    try:
        yield
    finally:
        patcher.undo()


def _alter_frames(mp):
    from v3d_tpu_torch.engines.image_diffusion import ImageDiffusionEngine
    from v3d_tpu_torch.engines.video_diffusion import VideoDiffusionEngine

    for cls, name in ((VideoDiffusionEngine, "decode_latents"), (ImageDiffusionEngine, "decode")):
        real = getattr(cls, name)

        def altered(self, *a, _real=real, **kw):
            out = _real(self, *a, **kw)
            return torch.cat([1.0 - out[:1], out[1:]])   # the first frame or image inverted
        mp.setattr(cls, name, altered)


def _alter_denoised(mp):
    from v3d_tpu_torch.diffusion.denoise import Denoiser

    real = Denoiser.__call__

    def altered(self, *a, **kw):
        out = real(self, *a, **kw)
        return torch.cat([out[:1] * 0.0, out[1:]])       # one row's answer lost
    mp.setattr(Denoiser, "__call__", altered)


def _alter_cond(mp):
    from v3d_tpu_torch.engines.video_diffusion import VideoDiffusionEngine

    real = VideoDiffusionEngine.encode_image

    def altered(self, *a, **kw):
        clip_emb, z = real(self, *a, **kw)
        return clip_emb.flip(-1), z                       # the image embedding scrambled
    mp.setattr(VideoDiffusionEngine, "encode_image", altered)


def _alter_guidance(mp):
    from v3d_tpu_torch.diffusion import guidance

    for cls in (guidance.VanillaCFG, guidance._FrameScaleGuider):
        real = cls.__call__

        def altered(self, x, sigma, _real=real):
            out = _real(self, x, sigma)
            return out + 0.5 * (out - x.chunk(2, dim=0)[0])   # the scale read 1.5 times
        mp.setattr(cls, "__call__", altered)


def _alter_euler(mp):
    from v3d_tpu_torch.diffusion.sampling import EulerEDMSampler

    mp.setattr(EulerEDMSampler, "correct",                       # a step 0.9 as long
               lambda self, euler, x, d, dt, *a: x + 0.9 * dt * d)


def _half_rows(mp, cls):
    real = cls.forward

    def halved(self, x, *a, **kw):
        out = real(self, x, *a, **kw)
        n = out.shape[0] // 2
        return torch.cat([out[:n], out[:n]])              # the second half never computed
    mp.setattr(cls, "forward", halved)


def _half_batch_unet(mp):
    from v3d_tpu_torch.models.unet2d import UNetModel
    from v3d_tpu_torch.models.video_unet import VideoUNet

    _half_rows(mp, VideoUNet)
    _half_rows(mp, UNetModel)


def _unchanged_state(mp):
    real = torch.optim.AdamW.step

    def step(self, *a, **kw):
        before = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = real(self, *a, **kw)
        with torch.no_grad():
            for p, b in zip((p for g in self.param_groups for p in g["params"]), before):
                p.copy_(b)
        return out
    mp.setattr(torch.optim.AdamW, "step", step)


def _half_train_batch(mp):
    from v3d_tpu_torch.engines.video_diffusion import VideoDiffusionEngine

    real = VideoDiffusionEngine.training_loss

    def halved(self, latents, cond, num_frames=None, sigmas=None, noise=None, **kw):
        n = latents.shape[0] // 2
        return real(self, latents[:n], {k: v[:n] for k, v in cond.items()},
                    num_frames=num_frames, sigmas=sigmas[:n], noise=noise[:n], **kw)
    mp.setattr(VideoDiffusionEngine, "training_loss", halved)


def _alter_loss(mp):
    from v3d_tpu_torch.engines.video_diffusion import VideoDiffusionEngine

    real = VideoDiffusionEngine.training_loss
    mp.setattr(VideoDiffusionEngine, "training_loss",
               lambda self, *a, **kw: 1.1 * real(self, *a, **kw))


def _alter_later_loss(mp):
    from v3d_tpu_torch.engines.video_diffusion import VideoDiffusionEngine

    from portbench.bench.manifest import PKG, read_json

    checked = read_json(PKG / "traffic" / "finetune.json")["params"]["checked_steps"]
    real = VideoDiffusionEngine.training_loss
    calls = [0]

    def altered(self, *a, **kw):
        calls[0] += 1                                     # set-up's checked steps as they are
        return real(self, *a, **kw) * (1.1 if calls[0] > checked else 1.0)
    mp.setattr(VideoDiffusionEngine, "training_loss", altered)


FAULTS = {
    "v3d512.generate": {"frames altered": _alter_frames, "an answer lost": _alter_denoised,
                        "conditioning altered": _alter_cond,
                        "half the CFG batch": _half_batch_unet,
                        "guidance altered": _alter_guidance, "Euler step altered": _alter_euler},
    "sd21-v768.txt2img": {"images altered": _alter_frames, "an answer lost": _alter_denoised,
                          "half the CFG batch": _half_batch_unet,
                          "guidance altered": _alter_guidance,
                          "Euler step altered": _alter_euler},
    "v3d512.finetune": {"state unchanged": _unchanged_state,
                        "half the batch": _half_train_batch, "loss altered": _alter_loss,
                        "later steps' loss altered": _alter_later_loss},
}
