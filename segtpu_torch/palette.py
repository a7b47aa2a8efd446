"""Color palettes for mask visualization and (DeepScene) label decoding,
as flat ``[r0, g0, b0, r1, g1, b1, ...]`` lists for PIL P-mode PNGs. A copy
of ``segtpu/palette.py``, so the port imports nothing of segtpu.

* VOC, ADE20K and COCO-Stuff use the PASCAL bit-interleaving generator.
* CityScapes colors are the official 19 train-class colors.
* DeepScene (Freiburg Forest) colors are the dataset's GT_color encoding:
  labels are decoded from RGB masks through this palette, so they must
  match the files bit for bit.
"""

from __future__ import annotations


def generated_palette(num_classes: int) -> list:
    """PASCAL-style colormap: bit i of the label index contributes bit (7-i)
    to each channel in rotation."""
    palette = []
    for j in range(num_classes):
        lab = j
        r = g = b = 0
        for i in range(8):
            r |= ((lab >> 0) & 1) << (7 - i)
            g |= ((lab >> 1) & 1) << (7 - i)
            b |= ((lab >> 2) & 1) << (7 - i)
            lab >>= 3
        palette.extend([r, g, b])
    return palette


def get_voc_palette(num_classes: int) -> list:
    return generated_palette(num_classes)


# Official cityscapes train-id colors (19 classes), from cityscapesScripts.
CityScapes_palette = [
    128, 64, 128,    # road
    244, 35, 232,    # sidewalk
    70, 70, 70,      # building
    102, 102, 156,   # wall
    190, 153, 153,   # fence
    153, 153, 153,   # pole
    250, 170, 30,    # traffic light
    220, 220, 0,     # traffic sign
    107, 142, 35,    # vegetation
    152, 251, 152,   # terrain
    70, 130, 180,    # sky
    220, 20, 60,     # person
    255, 0, 0,       # rider
    0, 0, 142,       # car
    0, 0, 70,        # truck
    0, 60, 100,      # bus
    0, 80, 100,      # train
    0, 0, 230,       # motorcycle
    119, 11, 32,     # bicycle
]
# the original repo's spelling, kept for configs that name it
CityScpates_palette = CityScapes_palette

# Freiburg Forest official GT_color encoding (object, road, grass, vegetation,
# sky, obstacle, void) — must match the dataset files bit-exactly because
# labels are decoded from these colors.
DeepScene_palette = [
    255, 0, 0,
    170, 170, 170,
    0, 255, 0,
    102, 102, 51,
    0, 60, 0,
    0, 120, 255,
    0, 0, 0,
]

ADE20K_palette = generated_palette(151)
COCO_palette = generated_palette(182)
