"""One-off asset tools: relighting, lens undistortion, paper figures.

Port of the JAX package's ``tools/`` (the reference's script layer:
utils/relight.py, utils/undistortion.py, utils/paper*.py in
gsgen3d/gsgen), with the same exports.
"""

from .undistort import (opencv_lens_distortion,          # noqa: F401
                        opencv_lens_distortion_fisheye,
                        opencv_lens_undistortion,
                        opencv_lens_undistortion_fisheye)
from .relight import relight_colors, relight_frames      # noqa: F401
from .snapshot import take_photos, take_spiral            # noqa: F401
