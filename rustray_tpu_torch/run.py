"""Render session — the host-side equivalent of ``Run``
(src/run.rs:98-662): owns the scene + renderer, runs the frame loop
(animation stepping), drains results into image + AOV buffers, saves
timestamped PNGs and prints the ffmpeg assembly hints.

Port of ``rustray_tpu/run.py``.  The session renders on ``device``
(default ``"cuda"``): the compiled scene goes to that device's tensors
and post-processing computes there.  Without CUDA the default device
raises; the CPU is used only when asked for (``device="cpu"``).  Every
frame of an animation compiles its scene and calls ``render()``, whose
renderer cache (``render/wavefront._RENDERER_CACHE``) hands the later
frames the CUDA graphs that the first one captured.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from . import spans
from .config import EngineConfig, RaytracingConfig
from .render.post import run_post_processing
from .render.wavefront import render
from .scene.scene import Scene
from .scene_arrays import to_torch

IMAGE_PATH = "data/output"
ANIMATION_PATH = "data/output/animation"
DEFAULT_RES = (800, 600)


@dataclass
class Stats:  # src/run.rs:45-95
    frame: int = 0
    output_time: datetime.datetime = field(default_factory=datetime.datetime.now)
    completed: bool = False
    # the last frame's render() (the ``render`` span)
    last_render_seconds: float = 0.0
    # the last frame's scene compile and its upload to the device (the
    # ``session.compile`` and ``session.upload`` spans)
    last_compile_seconds: float = 0.0

    def reset(self):
        self.frame = 0
        self.completed = False


class RenderSession:
    def __init__(self, width: int, height: int, scenes: List[str],
                 animate: bool = True, out_dir: str = IMAGE_PATH,
                 engine: Optional[EngineConfig] = None, preview: int = 0,
                 device: str = "cuda"):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(
                "RenderSession renders on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to render on the CPU")
        self.device = device
        self.width = width or DEFAULT_RES[0]
        self.height = height or DEFAULT_RES[1]
        self.scenes_list = scenes
        self.animate = animate
        self.out_dir = out_dir
        self.engine = engine or EngineConfig()
        self.preview = preview
        self.scene = Scene()
        self.stats = Stats()
        self.result = None
        self.cli_config_override: Optional[RaytracingConfig] = None

    # ----- scene init (src/run.rs:196-245) -----

    def init_scene(self):
        with spans.span("session.load"):
            scene = Scene()
            scene.raytracing_config.apply(self.scene.raytracing_config)
            scene.post_processing = self.scene.post_processing.copy()
            for path in self.scenes_list:
                scene.load(path)
            scene.cam.init(self.width, self.height)
            scene.find_and_set_default_env_if_needed()
            scene.apply_frame(self.stats.frame)
            scene.print()
            self.scene = scene

    def init(self):
        if self.width == 0 or self.height == 0:
            self.width, self.height = DEFAULT_RES
        self.stats.reset()
        self.init_scene()

    # ----- frame rendering -----

    def render_current_frame(self):
        with spans.span("session.frame"):
            self.scene.update()
            with spans.span("session.compile") as compiled:
                arrays = self.scene.compile(self.width, self.height)
            with spans.span("session.upload") as uploaded:
                sa, static = to_torch(*arrays, self.device)
            self.stats.last_compile_seconds = (compiled.seconds
                                               + uploaded.seconds)
            preview_path = None
            if self.preview:
                os.makedirs(self.out_dir, exist_ok=True)
                preview_path = os.path.join(self.out_dir, "preview.png")
            self.result = render(sa, static, self.scene.raytracing_config,
                                 self.engine, preview_path=preview_path,
                                 preview_every=max(1, self.preview))
            elapsed = spans.last["render"]
            self.stats.last_render_seconds = elapsed
            print(f"frame rendered ✅ (rendering time: {elapsed:.3f})")
        return self.result

    def print_frame_info(self):  # src/run.rs:487-504
        frames = 1
        if self.scene.animation.has_animation():
            frames = self.scene.animation.get_frames_amount_to_render()
        line = f"frame: {self.stats.frame + 1}/{frames}"
        print(f"\n{line}\n" + "=" * len(line))

    def save_image(self, postfix: Optional[str] = None) -> str:
        # src/run.rs:547-586 (timestamped filename, animation subdir)
        out_dir = self.out_dir
        if self.animate and self.scene.animation.has_animation():
            out_dir = os.path.join(self.out_dir, "animation")
        os.makedirs(out_dir, exist_ok=True)
        t = self.stats.output_time
        name = (f"output_{t.year}-{t.month}-{t.day}_{t.hour}-{t.minute}-{t.second}"
                f"_{self.stats.frame:08d}")
        if postfix:
            name += f"_{postfix}"
        path = os.path.join(out_dir, name + ".png")
        from PIL import Image
        Image.fromarray(self.result["image"]).save(path)
        print(f"image saved to {path}")
        return path

    def post_processing(self) -> str:  # src/run.rs:588-600
        processed = run_post_processing(
            self.scene.post_processing, self.result["image"],
            self.result["normal"], self.result["depth"],
            self.result["object_id"], device=self.device)
        self.result = dict(self.result, image=processed)
        return self.save_image("post")

    def print_ffmpeg_hints(self):  # src/run.rs:468-482
        t = self.stats.output_time
        stem = (f"{os.path.join(self.out_dir, 'animation')}/output_"
                f"{t.year}-{t.month}-{t.day}_{t.hour}-{t.minute}-{t.second}")
        fps = self.scene.animation.fps
        print("\nuse ffmpeg to combine frames:")
        print(f' - for mp4:  ffmpeg -i "{stem}_%08d.png" -c:v libx264 -vf fps={fps} "{stem}.mp4"')
        print(f' - for gif:  ffmpeg -i "{stem}_%08d.png" -vf fps={fps} "{stem}.gif"')
        print(f' - for webp: ffmpeg -i "{stem}_%08d.png" -vcodec libwebp -lossless 0 '
              f'-loop 0 -an -vf fps={fps} "{stem}.webp"')

    def run(self, save: bool = True):
        """Headless loop (src/run.rs:654-662): render every animation frame
        (or the single static frame), saving PNGs."""
        if not self.scene.items:
            print("no items to render")
            return
        self.scene.raytracing_config.print()
        self.print_frame_info()
        self.render_current_frame()
        if save:
            self.save_image()
        if self.scene.post_processing.cavity or self.scene.post_processing.outline:
            if save:
                self.post_processing()

        while (self.animate and self.scene.animation.has_animation()
               and self.scene.frame_exists(self.stats.frame + 1)):
            self.stats.frame += 1
            self.scene.apply_frame(self.stats.frame)
            self.print_frame_info()
            self.render_current_frame()
            if save:
                self.save_image()
        if self.animate and self.scene.animation.has_animation():
            self.print_ffmpeg_hints()
        print("done")

    def pick(self, x: int, y: int):
        from .render.picking import pick
        sa, static = to_torch(*self.scene.compile(self.width, self.height),
                              self.device)
        return pick(self.scene, sa, static, x, y)
