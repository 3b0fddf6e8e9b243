"""Visualization helpers (counterpart of `tpudenoise/utils/visualization.py`):
the per-class colour wheel, gt-box drawing for the training image summary,
an image grid, and cv2 image I/O.

The GPU machine has no PIL and no cv2, so `draw_bounding_boxes` draws in
numpy: each box's 2-pixel outline pixel for pixel as PIL's
`ImageDraw.rectangle(width=2)` draws it (corners truncated to ints, the
horizontal edges inclusive, the vertical edges' line ends exclusive, all
clipped to the image), and the class id as digits from the 5x7 glyph
table below, at PIL's text anchor (x1 + 2, max(y1 - 12, 0)) in the class
colour.  The one deviation from the JAX package's drawing is the label's
glyphs: PIL draws them in its default font.  `save_image` and
`load_images` import cv2 inside the function.
"""

from __future__ import annotations

import colorsys

import numpy as np

NUM_COLORS = 120

# 5x7 digit glyphs, one string of 5 columns per row ('#' is ink)
GLYPHS = {
    '0': ('.###.', '#...#', '#..##', '#.#.#', '##..#', '#...#', '.###.'),
    '1': ('..#..', '.##..', '..#..', '..#..', '..#..', '..#..', '.###.'),
    '2': ('.###.', '#...#', '....#', '...#.', '..#..', '.#...', '#####'),
    '3': ('####.', '....#', '....#', '.###.', '....#', '....#', '####.'),
    '4': ('...#.', '..##.', '.#.#.', '#..#.', '#####', '...#.', '...#.'),
    '5': ('#####', '#....', '####.', '....#', '....#', '#...#', '.###.'),
    '6': ('..##.', '.#...', '#....', '####.', '#...#', '#...#', '.###.'),
    '7': ('#####', '....#', '...#.', '..#..', '.#...', '.#...', '.#...'),
    '8': ('.###.', '#...#', '#...#', '.###.', '#...#', '#...#', '.###.'),
    '9': ('.###.', '#...#', '#...#', '.####', '....#', '...#.', '.##..'),
}
GLYPH_H, GLYPH_W, GLYPH_ADVANCE = 7, 5, 6


def class_color(class_id: int) -> tuple:
    """The class's (r, g, b) on a golden-ratio HSV wheel."""
    h = (class_id * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 1.0)
    return int(r * 255), int(g * 255), int(b * 255)


def _hline(img, y: int, xa: int, xb: int, color) -> None:
    """Pixels xa..xb of row y (inclusive), clipped."""
    h, w = img.shape[:2]
    xa, xb = max(xa, 0), min(xb, w - 1)
    if 0 <= y < h and xa <= xb:
        img[y, xa:xb + 1] = color


def _vline(img, x: int, ya: int, yb: int, color) -> None:
    """A vertical line from row ya towards row yb, yb not drawn (PIL's
    one-pixel line), clipped."""
    if ya == yb:
        return
    lo, hi = (ya, yb - 1) if ya < yb else (yb + 1, ya)
    h, w = img.shape[:2]
    lo, hi = max(lo, 0), min(hi, h - 1)
    if 0 <= x < w and lo <= hi:
        img[lo:hi + 1, x] = color


def draw_rectangle(img: np.ndarray, box, color, width: int = 2) -> None:
    """PIL's `ImageDraw.rectangle(box, outline=color, width=width)` on an
    (H, W, 3) u8 image, in place."""
    if box[2] < box[0] or box[3] < box[1]:
        raise ValueError(f'rectangle {box}: x1 < x0 or y1 < y0')
    x0, y0, x1, y1 = (int(v) for v in box)
    for i in range(width):
        _hline(img, y0 + i, x0, x1, color)
        _hline(img, y1 - i, x0, x1, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def label_extent(x: float, y: float, text: str) -> tuple:
    """(x0, y0, x1, y1), exclusive ends, of `draw_text`'s glyph cells."""
    x0, y0 = int(x), int(y)
    return x0, y0, x0 + GLYPH_ADVANCE * len(text), y0 + GLYPH_H


def draw_text(img: np.ndarray, x: float, y: float, text: str, color) -> None:
    """Digits from GLYPHS with their top-left at (x, y), in place,
    clipped."""
    h, w = img.shape[:2]
    x0, y0, _, _ = label_extent(x, y, text)
    for k, ch in enumerate(text):
        for r, row in enumerate(GLYPHS[ch]):
            for c, ink in enumerate(row):
                px, py = x0 + k * GLYPH_ADVANCE + c, y0 + r
                if ink == '#' and 0 <= px < w and 0 <= py < h:
                    img[py, px] = color


def draw_bounding_boxes(image: np.ndarray, gt_boxes: np.ndarray,
                        im_info=None) -> np.ndarray:
    """gt boxes (N, 5) = (x1, y1, x2, y2, class) drawn on a copy of an
    (H, W, 3) image (clipped to [0, 255] and cast to u8), each rescaled by
    1 / im_info[2]: a class-coloured 2-pixel outline and the class id."""
    img = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    scale = float(im_info[2]) if im_info is not None else 1.0
    for box in np.asarray(gt_boxes):
        x1, y1, x2, y2 = [float(v) / scale for v in box[:4]]
        cls = int(box[4]) if box.shape[0] > 4 else 0
        color = class_color(cls)
        draw_rectangle(img, (x1, y1, x2, y2), color)
        draw_text(img, x1 + 2, max(y1 - 12, 0), str(cls), color)
    return img


def image_grid(images, cols: int = 4, pad: int = 2) -> np.ndarray:
    """Tile images into one grid canvas (the reference's Helpers.py
    visualizer): cells of the largest image's size, `pad` black pixels
    between them."""
    images = [np.clip(np.asarray(im), 0, 255).astype(np.uint8)
              for im in images]
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    rows = (len(images) + cols - 1) // cols
    canvas = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad, 3),
                      np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        y, x = r * (h + pad), c * (w + pad)
        canvas[y:y + im.shape[0], x:x + im.shape[1]] = im[..., :3]
    return canvas


def save_image(path: str, image: np.ndarray):
    """Write an image with cv2 (clipped to [0, 255], u8)."""
    import cv2
    cv2.imwrite(path, np.clip(np.asarray(image), 0, 255).astype(np.uint8))


def load_images(path_glob: str, size=(1280, 720)):
    """The images matching path_glob (sorted), read with cv2, BGR -> RGB,
    resized to `size` (w, h): the Automold notebooks' loader."""
    import glob as _glob

    import cv2
    out = []
    for p in sorted(_glob.glob(path_glob)):
        im = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        out.append(cv2.resize(im, size))
    return out
