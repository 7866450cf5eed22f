"""Write the glyph table that ``pyprob_tpu_torch.models.MiniCaptcha`` renders
from: every printable ASCII character (codes 32-126) drawn as the JAX
package's ``MiniCaptcha.render`` draws it at its default arguments
(matplotlib's DejaVuSans-Bold at size 18, black on a white 28 × 28 RGB
canvas, the text at (6, 6)), each kept as the red channel's 784 uint8
bytes, row-major, characters in code order: 95 × 784 = 74,480 bytes in
``pyprob_tpu_torch/models/glyphs_dejavusans_bold_18.bin``.

Needs PIL and matplotlib (the table in the repository was written with
Pillow 12.1.0 and matplotlib 3.10.8).  Run from the repository root:

    python3 make_glyph_table.py [--check]

``--check`` compares the table on disk with a fresh rendering and exits 1
if they differ.
"""

import os
import sys

import numpy as np

FIRST, LAST = 32, 126
SIZE, HEIGHT, WIDTH, X, Y = 18, 28, 28, 6, 6
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pyprob_tpu_torch", "models",
                   "glyphs_dejavusans_bold_18.bin")


def render_red_channel(text):
    import matplotlib
    from PIL import Image, ImageDraw, ImageFont

    font = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf", "DejaVuSans-Bold.ttf")
    canvas = Image.new("RGB", (HEIGHT, WIDTH), (255, 255, 255))
    ImageDraw.Draw(canvas).text((X, Y), text, font=ImageFont.truetype(font, size=SIZE), fill="#000000")
    return np.asarray(canvas)[:, :, 0].copy()


def table():
    return np.stack([render_red_channel(chr(c)) for c in range(FIRST, LAST + 1)]).astype(np.uint8)


def main():
    t = table()
    if "--check" in sys.argv[1:]:
        on_disk = np.fromfile(OUT, dtype=np.uint8).reshape(t.shape)
        same = np.array_equal(on_disk, t)
        print("glyph table matches" if same else "glyph table differs")
        return 0 if same else 1
    t.tofile(OUT)
    print(f"wrote {OUT}: {t.nbytes} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
