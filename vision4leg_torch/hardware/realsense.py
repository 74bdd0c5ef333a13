"""RealSense depth camera thread (mirror of
vision4leg_tpu.hardware.realsense; reference a1_hardware/a1_utilities/
realsense.py: a capture thread resizing the depth stream to 64x64).

`A1RealSense` needs the `pyrealsense2` package and raises without it;
`FakeCamera` is the constant far-depth stand-in of a dry run.  Unlike the
JAX entry point, the port's deploy entry point does not swap the fake in
on the real robot when the package is missing: the policy must not walk
blind (`execute_locotransformer.make_camera`).
"""
from __future__ import annotations

import threading

import numpy as np

try:
  import pyrealsense2 as rs
  HAS_REALSENSE = True
except ImportError:
  rs = None
  HAS_REALSENSE = False

try:
  import cv2
except ImportError:
  cv2 = None


class A1RealSense:
  def __init__(self, width: int = 424, height: int = 240, fps: int = 30,
               out_size: int = 64):
    if not HAS_REALSENSE:
      raise ImportError("pyrealsense2 not available")
    self.out_size = out_size
    self.pipeline = rs.pipeline()
    cfg = rs.config()
    cfg.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
    self._cfg = cfg
    self._depth = np.full((out_size, out_size), 10.0)
    self._lock = threading.Lock()
    self._running = False
    self._thread = None

  def _loop(self):
    profile = self.pipeline.start(self._cfg)
    scale = profile.get_device().first_depth_sensor().get_depth_scale()
    try:
      while self._running:
        frames = self.pipeline.wait_for_frames()
        depth = np.asanyarray(frames.get_depth_frame().get_data()) * scale
        if cv2 is not None:
          depth = cv2.resize(depth, (self.out_size, self.out_size))
        with self._lock:
          self._depth = depth
    finally:
      self.pipeline.stop()

  def get_depth(self) -> np.ndarray:
    with self._lock:
      return self._depth.copy()

  def start_thread(self):
    self._running = True
    self._thread = threading.Thread(target=self._loop, daemon=True)
    self._thread.start()

  def stop_thread(self):
    self._running = False
    if self._thread:
      self._thread.join(timeout=2.0)


class FakeCamera:
  """Constant far-depth stand-in (the env's empty_image analog)."""

  def __init__(self, out_size: int = 64):
    self._depth = np.full((out_size, out_size), 10.0)

  def get_depth(self):
    return self._depth.copy()

  def start_thread(self):
    pass

  def stop_thread(self):
    pass
