"""Segmentation orchestration and mask utilities (port of
dream2real_tpu/perception/segmentation.py).

- the cache format: XMem_masks/rgb_%04d.png uint8 instance-id images, with
  XMem_vis_masks/ label visualisations; ``load_cached_masks`` replays them;
- a synthetic scan's ground-truth masks/ directory (``load_synth_masks``);
- ``Segmentor`` with injected backends: ``mask_generator`` (rgb -> list of
  boolean masks, SAM's role) and ``propagator`` (``start(rgb, id_mask)`` /
  ``step(rgb)``, XMem's role). The live SAM and XMem backends need weights
  that the repository does not hold and are not ported: without an injected
  backend, a scan with neither cache nor masks/ raises.
- the mask post-processing of the first frame (suppression of split,
  large, overlapping and small masks; the inflated background mask) and of
  the propagated frames (duplicate and disconnected pruning), with the
  OpenCV calls replaced by ``perception.imgproc``.

Convention: mask id 0 = background object, 1..K objects, 255 outside the
scene's bounds. Host numpy; every image file goes through the port's PNG
codec.
"""

from __future__ import annotations

import os

import numpy as np

from dream2real_tpu_torch.perception import imgproc
from dream2real_tpu_torch.utils.png import read_png, read_pngs, to_rgb, write_png

# The reference's label palette (vis_utils.py:15-26).
PASTEL_COLORS = np.array(
    [
        [255, 179, 186],
        [255, 223, 186],
        [255, 255, 186],
        [186, 255, 201],
        [186, 225, 255],
        [201, 186, 255],
        [255, 186, 255],
        [255, 186, 201],
        [186, 255, 255],
        [222, 186, 255],
    ]
)

_NO_BACKEND = ("live {} segmentation needs weights that the repository does not hold; run "
               "with use_cache_segs, provide masks/, or inject a {} backend")


def _first_channel(m: np.ndarray) -> np.ndarray:
    """The channel cv2.imread(-1)[..., 0] takes: blue of a colour file."""
    if m.ndim == 4:
        m = m[..., 2] if m.shape[-1] >= 3 else m[..., 0]
    return m.astype(np.uint8)


def load_cached_masks(out_dir: str, n_frames: int) -> np.ndarray:
    """Replay XMem_masks/rgb_%04d.png -> (N, H, W) uint8."""
    mask_dir = os.path.join(out_dir, "XMem_masks")
    paths = [os.path.join(mask_dir, f"rgb_{i:04d}.png") for i in range(n_frames)]
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"missing cached mask {p}")
    return _first_channel(read_pngs(paths))


def save_masks(out_dir: str, masks: np.ndarray):
    mask_dir = os.path.join(out_dir, "XMem_masks")
    os.makedirs(mask_dir, exist_ok=True)
    for i, m in enumerate(masks):
        write_png(os.path.join(mask_dir, f"rgb_{i:04d}.png"), np.asarray(m).astype(np.uint8))


def load_synth_masks(data_dir: str, n_frames: int) -> np.ndarray:
    """Ground-truth masks of a synthetic scan (data/synth.py layout)."""
    paths = [os.path.join(data_dir, "masks", f"mask_{i:04d}.png") for i in range(n_frames)]
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"missing synth mask {p}")
    return _first_channel(read_pngs(paths))


def _label_vis(mask: np.ndarray) -> np.ndarray:
    """Instance-id image -> the label visualisation the reference writes to
    XMem_vis_masks/ (BGR channel order, as its cv2.imwrite left it)."""
    vis = np.zeros((*mask.shape, 3), np.uint8)
    for idx in np.unique(mask):
        if idx == 0:
            continue
        vis[mask == idx] = PASTEL_COLORS[int(idx) % len(PASTEL_COLORS)]
    return vis[..., ::-1]


def _imwrite_bgr(path: str, img: np.ndarray):
    """cv2.imwrite semantics for the visualisations: a 3-channel array is
    BGR and is stored as RGB."""
    write_png(path, np.ascontiguousarray(img[..., ::-1]) if img.ndim == 3 else img)


class Segmentor:
    """Video instance segmentation orchestrator. Resolution order in
    ``segment`` / ``segment_associate``: cached XMem masks, then a synthetic
    scan's masks/, then the injected backends."""

    def __init__(self, device=None, mask_generator=None, propagator=None):
        self.device = device  # for the live backends' models (None: CUDA)
        self.mask_generator = mask_generator
        self.propagator = propagator

    def _resolve_backends(self, need_propagator: bool):
        if self.mask_generator is None:
            raise NotImplementedError(_NO_BACKEND.format("SAM", "mask_generator"))
        if need_propagator and self.propagator is None:
            raise NotImplementedError(_NO_BACKEND.format("XMem", "propagator"))

    def _save_frame(self, out_dir, index, mask):
        """The XMem_masks/ and XMem_vis_masks/ cache artifacts of a frame."""
        mask_dir = os.path.join(out_dir, "XMem_masks")
        vis_dir = os.path.join(out_dir, "XMem_vis_masks")
        os.makedirs(mask_dir, exist_ok=True)
        os.makedirs(vis_dir, exist_ok=True)
        write_png(os.path.join(mask_dir, f"rgb_{index:04d}.png"), mask.astype(np.uint8))
        _imwrite_bgr(os.path.join(vis_dir, f"rgb_{index:04d}.png"), _label_vis(mask))

    def segment(self, rgbs, depths, out_dir, show: bool = False, use_cache: bool = False):
        """Keyframe path: the first-frame segmenter on frame 0, propagated
        across the keyframes."""
        n = len(rgbs)
        if use_cache:
            return load_cached_masks(out_dir, n)
        if os.path.isdir(os.path.join(out_dir, "masks")):
            masks = load_synth_masks(out_dir, n)
            save_masks(out_dir, masks)  # also populate the standard cache
            return masks

        rgbs = np.asarray(rgbs)
        self._resolve_backends(need_propagator=n > 1)
        print("Segmenting frames...")
        sam_masks = postprocess_sam_masks(self.mask_generator(rgbs[0]), rgbs[0].shape[:2])
        scene_mask = integrate_masks(sam_masks)
        out = []
        for i in range(n):
            if i == 0:
                mask = self.propagator.start(rgbs[0], scene_mask) if n > 1 else scene_mask
            else:
                mask = self.propagator.step(rgbs[i])
            out.append(np.asarray(mask).astype(np.uint8))
            if out_dir is not None:
                self._save_frame(out_dir, i, out[-1])
        return np.stack(out)

    def segment_associate(
        self, video_path, depths, T_WC, intrinsics, out_dir,
        out_scene_bound_masks=None, scene_centre=None,
        show=False, use_cache=False, debug=False,
    ):
        """Dense-video path: the first-frame segmenter on the first
        associated video frame (rotated upright, scene-bounded), propagated
        through every video frame, pruned and saved at each keyframe."""
        n = len(depths)
        if use_cache:
            return load_cached_masks(out_dir, n)
        if os.path.isdir(os.path.join(out_dir, "masks")):
            masks = load_synth_masks(out_dir, n)
            save_masks(out_dir, masks)
            return masks

        from dream2real_tpu_torch.data.associate import associate

        assoc = associate(out_dir)
        files = sorted(os.listdir(video_path))
        self._resolve_backends(need_propagator=True)
        if debug:
            video_dir = os.path.join(out_dir, "XMem_video_masks")
            video_vis_dir = os.path.join(out_dir, "XMem_video_vis_masks")
            os.makedirs(video_dir, exist_ok=True)
            os.makedirs(video_vis_dir, exist_ok=True)

        refined_masks = []
        print("Segmenting frames...")
        for i, fname in enumerate(files):
            if i < assoc[0]:
                continue
            rgb = to_rgb(read_png(os.path.join(video_path, fname)))
            if i == assoc[0]:
                # Rotated upright, so that the scan is in distribution for
                # the segmenter.
                flipped = np.rot90(rgb, 1)
                sb = None
                if out_scene_bound_masks is not None:
                    sb = np.rot90(~np.asarray(out_scene_bound_masks[0]).astype(bool))
                sam_masks = postprocess_sam_masks(
                    self.mask_generator(flipped), flipped.shape[:2], scene_bound_mask=sb,
                )
                scene_mask = np.ascontiguousarray(np.rot90(integrate_masks(sam_masks), 3))
                mask = self.propagator.start(rgb, scene_mask)
            else:
                mask = self.propagator.step(rgb)
            mask = np.asarray(mask)

            if i in assoc:
                index = assoc.index(i)
                pruned = duplicate_prune(
                    mask, np.asarray(depths[index]), np.asarray(T_WC[index]),
                    intrinsics, scene_centre,
                )
                if out_scene_bound_masks is not None:
                    out_sb = np.asarray(out_scene_bound_masks[index])
                    pruned = np.where(out_sb == 255, 255, pruned).astype(np.uint8)
                refined_masks.append(pruned)
                self._save_frame(out_dir, index, pruned)
            if debug:
                write_png(os.path.join(video_dir, f"rgb_{i}.png"), mask.astype(np.uint8))
                _imwrite_bgr(os.path.join(video_vis_dir, f"rgb_{i}.png"), _label_vis(mask))
        return refined_masks

    def free(self):
        for backend in (self.mask_generator, self.propagator):
            if backend is not None and hasattr(backend, "free"):
                backend.free()
        self.mask_generator = None
        self.propagator = None


# ---------------------------------------------------------------------------
# First-frame mask post-processing, on lists of boolean instance masks.


def subpart_suppression(masks: list[np.ndarray], threshold: float = 0.1) -> list[np.ndarray]:
    """Drop the smaller of any overlapping pair."""
    remove = set()
    for i in range(len(masks)):
        ai = masks[i].sum()
        for j in range(i + 1, len(masks)):
            aj = masks[j].sum()
            inter = (masks[i] & masks[j]).sum()
            if (ai and inter / ai > threshold) or (aj and inter / aj > threshold):
                remove.add(i if ai < aj else j)
    return [m for k, m in enumerate(masks) if k not in remove]


def large_obj_suppression(masks, img_shape, threshold: float = 0.3):
    """Drop masks covering more than ``threshold`` of the image (background)."""
    area = img_shape[0] * img_shape[1]
    return [m for m in masks if m.sum() / area <= threshold]


def small_obj_suppression(masks, area_thresh: int = 80, side_thresh: int = 20):
    """Drop tiny or sliver masks that cannot be grasped."""
    out = []
    for m in masks:
        if m.sum() < area_thresh:
            continue
        try:
            if get_smallest_side(m)[1] <= side_thresh:
                continue
        except (ValueError, IndexError):
            continue
        out.append(m)
    return out


def disconnected_components_suppression(masks):
    """Keep only masks that are one island after a 5 px dilation."""
    out = []
    for m in masks:
        d = imgproc.dilate(m.astype(np.uint8), 5)
        if imgproc.connected_components(d)[0] == 2:
            out.append(m)
    return out


def build_background_mask(masks, inflation_factor: float = 1.6) -> np.ndarray:
    """Background = complement of the union of the inflated object masks
    (the inflation removes the objects' shadows)."""
    inflated = [rescale_mask(m.astype(np.uint8), inflation_factor) > 0 for m in masks]
    return ~np.logical_or.reduce(inflated)


def postprocess_sam_masks(masks, img_shape, scene_bound_mask=None):
    """The whole first-frame pipeline; the background mask goes in front.
    -> list of boolean masks."""
    masks = [np.asarray(m, bool) for m in masks]
    if scene_bound_mask is not None:
        sb = np.asarray(scene_bound_mask, bool)
        masks = [m & sb for m in masks]
    masks = disconnected_components_suppression(masks)
    masks = large_obj_suppression(masks, img_shape)
    masks = subpart_suppression(masks)
    masks = small_obj_suppression(masks)
    bg = build_background_mask(masks) if masks else np.ones(img_shape[:2], bool)
    return [bg] + masks


def integrate_masks(masks) -> np.ndarray:
    """List of boolean masks -> uint8 instance-id image; later masks
    overwrite earlier ones."""
    out = np.zeros(np.asarray(masks[0]).shape, np.uint8)
    for idx, m in enumerate(masks):
        out[np.asarray(m, bool)] = idx
    return out


def duplicate_prune(mask, depth, T_WC, intrinsics, scene_centre) -> np.ndarray:
    """Per object id, keep only the connected component whose back-projected
    centroid is nearest the scene centre (removes the duplicate blobs that
    video propagation leaves)."""
    mask = np.asarray(mask)
    depth = np.asarray(depth)
    K = np.asarray(intrinsics)
    centre = np.asarray(scene_centre, np.float64)
    refined = np.zeros_like(mask)
    for i in np.unique(mask):
        if i == 0:
            continue
        curr = (mask == i).astype(np.uint8)
        n_comps, comps = imgproc.connected_components(curr)
        if n_comps > 2:
            best, best_dist = None, np.inf
            for ci in range(1, n_comps):
                cm = comps == ci
                if cm.sum() < 200:
                    continue
                vs, us = np.nonzero(cm & (depth > 0))
                if len(vs) == 0:
                    continue
                z = depth[vs, us]
                x = (us - K[0, 2]) / K[0, 0] * z
                y = (vs - K[1, 2]) / K[1, 1] * z
                cam = np.stack([x, y, z], -1)
                # The points are taken to the world frame.
                world = cam @ np.asarray(T_WC)[:3, :3].T + np.asarray(T_WC)[:3, 3]
                dist = np.linalg.norm(world.mean(0) - centre)
                if dist < best_dist:
                    best, best_dist = cm, dist
            if best is not None:
                refined[best] = i
        else:
            refined[comps == 1] = i
    return refined.astype(np.uint8)


def disconnected_prune(mask) -> np.ndarray:
    """Per object id, keep only the largest connected component (>= 200 px)."""
    mask = np.asarray(mask)
    refined = np.zeros_like(mask)
    for i in np.unique(mask):
        if i == 0:
            continue
        curr = (mask == i).astype(np.uint8)
        n_comps, comps = imgproc.connected_components(curr)
        if n_comps > 2:
            best, best_area = None, 0
            for ci in range(1, n_comps):
                cm = comps == ci
                area = cm.sum()
                if area < 200:
                    continue
                if area >= best_area:
                    best, best_area = cm, area
            if best is not None:
                refined[best] = i
        else:
            refined[comps == 1] = i
    return refined.astype(np.uint8)


def _min_area_box(mask: np.ndarray) -> np.ndarray:
    """The int64 corners of the min-area rectangle of the mask's longest
    external contour."""
    contours = imgproc.external_contours(mask.astype(np.uint8) * 255)
    max_contour = max(contours, key=len)
    return imgproc.box_points(imgproc.min_area_rect(max_contour)).astype(np.int64)


def get_smallest_side(mask: np.ndarray):
    """(direction, length) of the shorter side of the min-area rectangle."""
    box = _min_area_box(mask)
    w = np.linalg.norm(box[0] - box[1])
    h = np.linalg.norm(box[1] - box[2])
    if w < h:
        return (box[2] - box[0]) / max(w, 1e-9), w
    return (box[3] - box[1]) / max(h, 1e-9), h


def get_biggest_side(mask: np.ndarray):
    """(direction, length) of the longer side of the min-area rectangle."""
    box = _min_area_box(mask)
    w = np.linalg.norm(box[0] - box[1])
    h = np.linalg.norm(box[1] - box[2])
    if w > h:
        return (box[2] - box[0]) / w, w
    return (box[3] - box[1]) / h, h


def get_obj_img(img: np.ndarray, obj_mask: np.ndarray) -> np.ndarray:
    """Tight RGBA crop of an object."""
    rows = np.where(obj_mask.any(axis=1))[0]
    cols = np.where(obj_mask.any(axis=0))[0]
    r0, r1 = rows[0], rows[-1]
    c0, c1 = cols[0], cols[-1]
    crop = img[r0 : r1 + 1, c0 : c1 + 1]
    a = obj_mask[r0 : r1 + 1, c0 : c1 + 1].astype(img.dtype) * 255
    return np.concatenate([crop, a[..., None]], axis=-1)


def mask_touches_edge(mask: np.ndarray) -> bool:
    rows = np.where(mask.any(axis=1))[0]
    cols = np.where(mask.any(axis=0))[0]
    if len(rows) == 0:
        return False
    return (rows[0] == 0 or rows[-1] == mask.shape[0] - 1
            or cols[0] == 0 or cols[-1] == mask.shape[1] - 1)


def get_thumbnail(img: np.ndarray, obj_mask: np.ndarray, padding: int = 5,
                  use_mask: bool = True) -> np.ndarray:
    """Crop around the mask with padding; masked-out pixels white."""
    if use_mask:
        img = img.copy()
        img[~obj_mask] = 255
    rows = np.where(obj_mask.any(axis=1))[0]
    cols = np.where(obj_mask.any(axis=0))[0]
    r0 = max(0, rows[0] - padding)
    r1 = min(img.shape[0] - 1, rows[-1] + padding)
    c0 = max(0, cols[0] - padding)
    c1 = min(img.shape[1] - 1, cols[-1] + padding)
    return img[r0 : r1 + 1, c0 : c1 + 1]


def centre_of_mass(binary_image: np.ndarray) -> np.ndarray:
    """(i, j) centre of a binary image, truncated to int."""
    m = imgproc.moments(binary_image)
    return np.array([int(m["m01"] / m["m00"]), int(m["m10"] / m["m00"])])


def rescale_mask(mask: np.ndarray, scale: float) -> np.ndarray:
    """Dilate (erode) with a 3 x 3 kernel until the longest side has grown
    (shrunk) by ``scale``."""
    if scale == 1.0:
        return mask
    mask = mask.astype(np.uint8)
    _, length = get_biggest_side(mask)
    new_length = length * scale
    op = imgproc.dilate if scale >= 1 else imgproc.erode
    cond = (lambda l: l < new_length) if scale >= 1 else (lambda l: l > new_length)
    while cond(length):
        mask = op(mask, 3)
        prev = length
        _, length = get_biggest_side(mask)
        if prev == length:
            break
    return mask


def remove_components_at_edges(mask: np.ndarray) -> np.ndarray:
    """Zero the connected components that touch the image edge."""
    mask = mask.copy()
    n, comp = imgproc.connected_components(mask.astype(np.uint8))
    for i in range(n):
        cm = comp == i
        if mask_touches_edge(cm):
            mask[cm] = 0
    return mask
