"""Interactive demo app (counterpart of v3d_tpu/apps/serve.py, itself of the
reference's app.py gradio Blocks, :29-230): upload an image, set the border
ratio, the CFG range, the decoding chunk and the seed, and get the orbit
video.

    python -m v3d_tpu_torch.apps.serve [--checkpoint V3D_512.ckpt] [--port 7860]

gradio is imported in ``build_demo``; without it the call raises the JAX
app's ImportError.  The engine is built on the first request (on
``device``, seeded random weights unless ``checkpoint`` is given) and kept
for the later ones; each request's frames are written as an mp4.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def build_demo(checkpoint: str = None, device="cuda"):
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "gradio is required for the demo app (pip install gradio); the "
            "CLI pipelines in v3d_tpu_torch.apps.* provide the same functionality "
            "headlessly") from e

    from PIL import Image

    from v3d_tpu_torch.apps import generate
    from v3d_tpu_torch.data import video_io

    state = {"engine": None}

    def run(image_path, border_ratio, min_cfg, max_cfg, decoding_t, seed):
        frames, engine, _ = generate.sample_one(
            np.asarray(Image.open(image_path)), engine=state["engine"],
            checkpoint=checkpoint, border_ratio=border_ratio,
            min_guidance_scale=min_cfg, max_guidance_scale=max_cfg,
            decoding_t=int(decoding_t), seed=int(seed), device=device)
        state["engine"] = engine
        fd, out = tempfile.mkstemp(suffix=".mp4")
        os.close(fd)
        video_io.write_video(out, frames, fps=3)
        return out

    with gr.Blocks(title="V3D") as demo:
        gr.Markdown("# V3D: image to 360 orbit video")
        with gr.Row():
            img = gr.Image(type="filepath", label="input image")
            vid = gr.Video(label="orbit video")
        border = gr.Slider(0.0, 0.5, value=0.3, label="border ratio")
        min_cfg = gr.Slider(0.0, 10.0, value=3.5, label="min CFG")
        max_cfg = gr.Slider(0.0, 10.0, value=3.5, label="max CFG")
        dec_t = gr.Slider(1, 18, value=6, step=1, label="decoding chunk")
        seed = gr.Number(value=23, label="seed")
        btn = gr.Button("Generate")
        btn.click(run, [img, border, min_cfg, max_cfg, dec_t, seed], vid)
    return demo


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu only when asked for)")
    args = p.parse_args(argv)
    build_demo(args.checkpoint, args.device).launch(server_port=args.port)


if __name__ == "__main__":
    main()
