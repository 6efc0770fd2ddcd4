"""The paper's own workload: cornerHarris_Demo (OpenCV) on a 1920×1080 frame.

Not an LM arch — this config drives ``chip_smoke.py`` and
``repro_torch.quickstart``, reproducing the paper's processing flow:
cvtColor → cornerHarris → normalize → convertScaleAbs.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class HarrisConfig:
    arch_id: str = "harris-demo"
    height: int = 1080
    width: int = 1920
    block_size: int = 2          # cv::cornerHarris blockSize
    ksize: int = 3               # Sobel aperture
    k: float = 0.04              # Harris k
    # paper Table I reference timings [ms] on Zynq (original / offloaded)
    paper_times_orig = {"cvtColor": 46.3, "cornerHarris": 999.0,
                        "normalize": 108.0, "convertScaleAbs": 217.8}
    paper_times_offl = {"cvtColor": 39.8, "cornerHarris": 13.6,
                        "normalize": 80.2, "convertScaleAbs": 13.2}
    paper_total_orig_ms: float = 1371.1
    paper_total_offl_ms: float = 83.8
    paper_speedup: float = 15.36


config = HarrisConfig()
