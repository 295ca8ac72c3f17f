"""Video writing with a fallback chain.

Counterpart of next3d_tpu/utils/video.py ``VideoWriter``: imageio's ffmpeg
writer where it is installed, else OpenCV's, else a directory of PNG frames
(``<path stem>_frames/000000.png``, ...), written by ``utils/png.py``.
"""

from __future__ import annotations

import os

from .png import write_png


class VideoWriter:
    def __init__(self, path, fps=30):
        self.path = path
        self.fps = fps
        self._imageio = None
        self._cv2 = None
        self._frame_dir = None
        self._count = 0

    def _open(self, frame):
        h, w = frame.shape[:2]
        try:
            import imageio
            self._imageio = imageio.get_writer(self.path, mode='I',
                                               fps=self.fps, codec='libx264',
                                               bitrate='10M')
            return
        except Exception:
            self._imageio = None
        try:
            import cv2
            fourcc = cv2.VideoWriter_fourcc(*'mp4v')
            vw = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
            if vw.isOpened():
                self._cv2 = vw
                return
        except Exception:
            pass
        self._frame_dir = os.path.splitext(self.path)[0] + '_frames'
        os.makedirs(self._frame_dir, exist_ok=True)

    def append(self, frame_uint8_rgb):
        if (self._imageio is None and self._cv2 is None
                and self._frame_dir is None):
            self._open(frame_uint8_rgb)
        if self._imageio is not None:
            self._imageio.append_data(frame_uint8_rgb)
        elif self._cv2 is not None:
            import cv2
            self._cv2.write(cv2.cvtColor(frame_uint8_rgb, cv2.COLOR_RGB2BGR))
        else:
            write_png(os.path.join(self._frame_dir, f'{self._count:06d}.png'),
                      frame_uint8_rgb)
        self._count += 1

    def close(self):
        if self._imageio is not None:
            self._imageio.close()
        if self._cv2 is not None:
            self._cv2.release()
        return self._frame_dir or self.path
