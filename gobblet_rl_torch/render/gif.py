"""GIF recording of rendered games.

Port of ``gobblet_rl_tpu/render/gif.py``.  The frames (pygame surfaces or
``(H, W, 3)`` arrays) are kept in memory and written in-process with
Pillow; without Pillow each frame goes to a PNG file in the project root
and ImageMagick's ``convert`` joins them, as the reference's recorder did.
``pygame`` and ``PIL`` are imported only where a frame needs them.
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np

from gobblet_rl_torch.utils.helpers import get_project_root


class GIFRecorder:
    """Capture pygame surfaces (or raw rgb arrays) and write a .gif."""

    def __init__(self, out_file: str = "game.gif"):
        print("Initializing GIF Recorder...")
        print(f"Output of the recording will be saved to {out_file}.")
        self.frames: list[np.ndarray] = []
        self.frame_num = 0
        self.start_time = time.time()
        self.path = get_project_root()
        self.out_file = out_file
        self.ended = False

    def capture_frame(self, surf) -> None:
        """Append one frame; ``surf`` is a pygame surface or (H, W, 3) array."""
        if self.ended:
            return
        if isinstance(surf, np.ndarray):
            frame = surf
        else:
            import pygame

            frame = np.transpose(
                np.array(pygame.surfarray.pixels3d(surf)), (1, 0, 2)
            ).copy()
        self.frames.append(frame.astype(np.uint8))
        self.frame_num += 1

    def end_recording(self, surf=None) -> None:
        """Finish and write the GIF (adds 10 trailing frames like the
        reference so the final position lingers, utils.py:148-151)."""
        if self.ended:
            return
        if surf is not None:
            for _ in range(10):
                self.capture_frame(surf)
        if not self.frames:
            self.ended = True
            return

        duration = time.time() - self.start_time
        ms_per_frame = max(int(duration / max(self.frame_num, 1) * 1000), 20)
        try:
            from PIL import Image

            images = [Image.fromarray(f) for f in self.frames]
            images[0].save(
                self.out_file,
                save_all=True,
                append_images=images[1:],
                duration=ms_per_frame,
                loop=0,
            )
        except ImportError:  # pragma: no cover - Pillow is normally present
            tmp_files = []
            for i, frame in enumerate(self.frames):
                name = os.path.join(self.path, f"temp_{time.time()}_{i}.png")
                _write_png(name, frame)
                tmp_files.append(name)
            subprocess.call(
                ["convert", "-delay", str(ms_per_frame // 10), "-loop", "0"]
                + tmp_files
                + [self.out_file],
                cwd=self.path,
            )
            for name in tmp_files:
                os.remove(name)
        print(f"Saved recording to {self.out_file}")
        self.ended = True


def _write_png(path: str, frame: np.ndarray) -> None:  # pragma: no cover
    import pygame

    surf = pygame.surfarray.make_surface(np.transpose(frame, (1, 0, 2)))
    pygame.image.save(surf, path)
