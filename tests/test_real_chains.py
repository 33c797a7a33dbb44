"""The pose-graph backend consumes the reference's REAL saved trajectories
as input — not just as format fixtures:

  * revisit detection with the production drift-scaled gate must yield
    ZERO detections on real non-looping KITTI drives (false-positive side
    of the gate; synthetic ring courses can only measure the true-positive
    side);
  * 3-chain fusion (VO+LO+MO odometry factors through the banded solver)
    must stay anchored to the MO chain — deviation well under the real
    MO-LO disagreement — and stay finite.

Source data: /root/reference/src/vloam_main/results/<drive>/{VO,LO,MO}{d}.txt
(writer vloam_tf.cpp:100-106); full sweep in tools/real_chains.py."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import real_chains  # noqa: E402

pytestmark = pytest.mark.skipif(
    not os.path.isdir(real_chains.RESULTS), reason="reference results not present"
)


@pytest.mark.slow
@pytest.mark.parametrize("drive,det", [
    ("2011_10_03_drive_0042", "1"),      # 539 frames, 1.3 km — the longest
    ("2011_09_26_drive_0005", "0"),
])
def test_real_chain_detection_and_fusion(drive, det):
    r = real_chains.analyse(drive, det)
    assert r["spurious_revisits"] == 0, r
    assert r["fused_finite"]
    # fusion anchored: the fused chain deviates from MO by far less than
    # the chains disagree with each other
    assert r["fused_mo_dev_m"] < 0.5 * max(r["mo_lo_gap_m"], 0.2), r
