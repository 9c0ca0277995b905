"""KITTI split metadata (factual tables, compactly encoded).

The port's own copy of ``r2dm_tpu/data/kitti_splits.py``. Sources
(re-encoded, not copied verbatim):
  - KITTI-360 lidargen sequence splits: reference data/kitti_360/kitti_360.py:19-24
  - KITTI Raw odometry->raw drive mapping: reference data/kitti_raw/kitti_raw.py:211-224
  - KITTI Raw category drive lists (city/road/residential used for the test
    split): reference data/kitti_raw/kitti_raw.py:26-199 (originally from the
    official KITTI raw-data recording categories)
"""

from __future__ import annotations

# ------------------------------------------------------------- KITTI-360
KITTI360_SEQUENCE_SPLITS = {
    "train": (3, 4, 5, 6, 7, 9, 10),
    "test": (0, 2),
}

# ------------------------------------------------------------- KITTI Raw
# odometry sequence -> (date, drive, first frame, last frame)
ODOMETRY_TO_RAW = {
    0: ("2011_10_03", 27, 0, 4540),
    1: ("2011_10_03", 42, 0, 1100),
    2: ("2011_10_03", 34, 0, 4660),
    3: ("2011_09_26", 67, 0, 800),  # drive not released in KITTI Raw
    4: ("2011_09_30", 16, 0, 270),
    5: ("2011_09_30", 18, 0, 2760),
    6: ("2011_09_30", 20, 0, 1100),
    7: ("2011_09_30", 27, 0, 1100),
    8: ("2011_09_30", 28, 1100, 5170),
    9: ("2011_09_30", 33, 0, 1590),
    10: ("2011_09_30", 34, 0, 1200),
}

KITTIRAW_SEQUENCE_SPLITS = {
    "train": (0, 1, 2, 3, 4, 5, 6, 7, 9, 10),
    "validation": (8,),
    "test": None,  # city+road+residential drives not in train/validation
}

# category -> {date: (drive numbers,)}
RAW_CATEGORY_DRIVES = {
    "city": {
        "2011_09_26": (1, 2, 5, 9, 11, 13, 14, 17, 18, 48, 51, 56, 57, 59,
                       60, 84, 91, 93, 95, 96, 104, 106, 113, 117),
        "2011_09_28": (1, 2),
        "2011_09_29": (26, 71),
    },
    "residential": {
        "2011_09_26": (19, 20, 22, 23, 35, 36, 39, 46, 61, 64, 79, 86, 87),
        "2011_09_30": (18, 20, 27, 28, 33, 34),
        "2011_10_03": (27, 34),
    },
    "road": {
        "2011_09_26": (15, 27, 28, 29, 32, 52, 70, 101),
        "2011_09_29": (4,),
        "2011_09_30": (16,),
        "2011_10_03": (42, 47),
    },
}


def drive_name(date: str, drive: int) -> str:
    return f"{date}_drive_{drive:04d}_sync"


def raw_trainval_drives() -> set[str]:
    """Drives covered by the odometry train/val sequences (excluded from the
    test split, reference kitti_raw.py:355-360)."""
    return {
        drive_name(date, drive) for date, drive, _, _ in ODOMETRY_TO_RAW.values()
    }


def raw_test_drives() -> list[str]:
    """city + road + residential drives not in train/val, reference order
    (category loop, then listed drive order within each category)."""
    trainval = raw_trainval_drives()
    out = []
    for category in ("city", "road", "residential"):
        names = [
            drive_name(date, d)
            for date, drives in RAW_CATEGORY_DRIVES[category].items()
            for d in drives
        ]
        # reference lists are sorted lexicographically within a category
        for name in sorted(names):
            if name not in trainval:
                out.append(name)
    return out
