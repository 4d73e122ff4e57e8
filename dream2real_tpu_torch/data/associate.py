"""Sparse-keyframe <-> dense-video frame association (port of
dream2real_tpu/data/associate.py): associate_index.txt when present, else
nearest-timestamp matching of rgb_timestamps.txt against seg_timestamps.txt,
with the frame-0 "no earlier frame" guard. Host code."""

from __future__ import annotations

import os


def read_file_list(filename: str) -> dict:
    """The first value of every non-comment line, as float keys in file order."""
    with open(filename) as f:
        data = f.read()
    lines = data.replace(",", " ").replace("\t", " ").split("\n")
    rows = [
        [v.strip() for v in line.split(" ") if v.strip() != ""]
        for line in lines
        if len(line) > 0 and line[0] != "#"
    ]
    return dict((float(r[0]), 0) for r in rows)


def associate(data_dir: str) -> list[int]:
    """Index of the video frame for each keyframe of the scan."""
    associate_file = os.path.join(data_dir, "associate_index.txt")
    if os.path.exists(associate_file):
        return [int(k) for k in read_file_list(associate_file)]

    first = list(read_file_list(os.path.join(data_dir, "rgb_timestamps.txt")))
    second = list(read_file_list(os.path.join(data_dir, "seg_timestamps.txt")))

    out = []
    for i, t_rgb in enumerate(first):
        min_diff = 1e9
        min_index = None
        for j, t_seg in enumerate(second):
            if i == 0 and t_rgb > t_seg:
                continue  # the first keyframe takes no earlier video frame
            diff = abs(t_rgb - t_seg)
            if diff < min_diff:
                min_diff = diff
                min_index = j
        out.append(min_index)
    assert len(out) == len(first)
    return out
