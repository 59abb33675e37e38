"""ADE20K 150-class metadata (counterpart of ``fovealseg_tpu/assets/ade20k.py``).

The reference ships two loose files: ``data/color150.mat`` (the 150x3 uint8
palette of the eval visualisation) and ``data/object150_info.csv`` (class
names, stuff flags, pixel ratios and image counts). This module carries both
tables as Python data, with writers for the two on-disk formats. It holds
the port's one copy of the palette (``utils/ade.py`` reads it).
"""

from __future__ import annotations

import csv

import numpy as np

# 150x3 uint8 RGB palette (contents of color150.mat's 'colors' array).
ADE20K_COLORS_TABLE = (
    (120, 120, 120), (180, 120, 120), (6, 230, 230), (80, 50, 50), (4, 200, 3),
    (120, 120, 80), (140, 140, 140), (204, 5, 255), (230, 230, 230), (4, 250, 7),
    (224, 5, 255), (235, 255, 7), (150, 5, 61), (120, 120, 70), (8, 255, 51),
    (255, 6, 82), (143, 255, 140), (204, 255, 4), (255, 51, 7), (204, 70, 3),
    (0, 102, 200), (61, 230, 250), (255, 6, 51), (11, 102, 255), (255, 7, 71),
    (255, 9, 224), (9, 7, 230), (220, 220, 220), (255, 9, 92), (112, 9, 255),
    (8, 255, 214), (7, 255, 224), (255, 184, 6), (10, 255, 71), (255, 41, 10),
    (7, 255, 255), (224, 255, 8), (102, 8, 255), (255, 61, 6), (255, 194, 7),
    (255, 122, 8), (0, 255, 20), (255, 8, 41), (255, 5, 153), (6, 51, 255),
    (235, 12, 255), (160, 150, 20), (0, 163, 255), (140, 140, 140), (250, 10, 15),
    (20, 255, 0), (31, 255, 0), (255, 31, 0), (255, 224, 0), (153, 255, 0),
    (0, 0, 255), (255, 71, 0), (0, 235, 255), (0, 173, 255), (31, 0, 255),
    (11, 200, 200), (255, 82, 0), (0, 255, 245), (0, 61, 255), (0, 255, 112),
    (0, 255, 133), (255, 0, 0), (255, 163, 0), (255, 102, 0), (194, 255, 0),
    (0, 143, 255), (51, 255, 0), (0, 82, 255), (0, 255, 41), (0, 255, 173),
    (10, 0, 255), (173, 255, 0), (0, 255, 153), (255, 92, 0), (255, 0, 255),
    (255, 0, 245), (255, 0, 102), (255, 173, 0), (255, 0, 20), (255, 184, 184),
    (0, 31, 255), (0, 255, 61), (0, 71, 255), (255, 0, 204), (0, 255, 194),
    (0, 255, 82), (0, 10, 255), (0, 112, 255), (51, 0, 255), (0, 194, 255),
    (0, 122, 255), (0, 255, 163), (255, 153, 0), (0, 255, 10), (255, 112, 0),
    (143, 255, 0), (82, 0, 255), (163, 255, 0), (255, 235, 0), (8, 184, 170),
    (133, 0, 255), (0, 255, 92), (184, 0, 255), (255, 0, 31), (0, 184, 255),
    (0, 214, 255), (255, 0, 112), (92, 255, 0), (0, 224, 255), (112, 224, 255),
    (70, 184, 160), (163, 0, 255), (153, 0, 255), (71, 255, 0), (255, 0, 163),
    (255, 204, 0), (255, 0, 143), (0, 255, 235), (133, 255, 0), (255, 0, 235),
    (245, 0, 255), (255, 0, 122), (255, 245, 0), (10, 190, 212), (214, 255, 0),
    (0, 204, 255), (20, 0, 255), (255, 255, 0), (0, 153, 255), (0, 41, 255),
    (0, 255, 204), (41, 0, 255), (41, 255, 0), (173, 0, 255), (0, 245, 255),
    (71, 0, 255), (122, 0, 255), (0, 255, 184), (0, 92, 255), (184, 255, 0),
    (0, 133, 255), (255, 214, 0), (25, 194, 194), (102, 255, 0), (92, 0, 255),
)

# Class names, object150_info.csv order (Idx 1..150).
ADE20K_NAMES = (
    'wall', 'building;edifice', 'sky', 'floor;flooring', 'tree', 'ceiling',
    'road;route', 'bed', 'windowpane;window', 'grass', 'cabinet',
    'sidewalk;pavement', 'person;individual;someone;somebody;mortal;soul',
    'earth;ground', 'door;double;door', 'table', 'mountain;mount',
    'plant;flora;plant;life', 'curtain;drape;drapery;mantle;pall', 'chair',
    'car;auto;automobile;machine;motorcar', 'water', 'painting;picture',
    'sofa;couch;lounge', 'shelf', 'house', 'sea', 'mirror',
    'rug;carpet;carpeting', 'field', 'armchair', 'seat', 'fence;fencing',
    'desk', 'rock;stone', 'wardrobe;closet;press', 'lamp',
    'bathtub;bathing;tub;bath;tub', 'railing;rail', 'cushion',
    'base;pedestal;stand', 'box', 'column;pillar', 'signboard;sign',
    'chest;of;drawers;chest;bureau;dresser', 'counter', 'sand', 'sink',
    'skyscraper', 'fireplace;hearth;open;fireplace', 'refrigerator;icebox',
    'grandstand;covered;stand', 'path', 'stairs;steps', 'runway',
    'case;display;case;showcase;vitrine',
    'pool;table;billiard;table;snooker;table', 'pillow',
    'screen;door;screen', 'stairway;staircase', 'river', 'bridge;span',
    'bookcase', 'blind;screen', 'coffee;table;cocktail;table',
    'toilet;can;commode;crapper;pot;potty;stool;throne', 'flower', 'book',
    'hill', 'bench', 'countertop',
    'stove;kitchen;stove;range;kitchen;range;cooking;stove',
    'palm;palm;tree', 'kitchen;island',
    'computer;computing;machine;computing;device;data;processor;electronic;computer;information;processing;system',
    'swivel;chair', 'boat', 'bar', 'arcade;machine',
    'hovel;hut;hutch;shack;shanty',
    'bus;autobus;coach;charabanc;double-decker;jitney;motorbus;motorcoach;omnibus;passenger;vehicle',
    'towel', 'light;light;source', 'truck;motortruck', 'tower',
    'chandelier;pendant;pendent', 'awning;sunshade;sunblind',
    'streetlight;street;lamp', 'booth;cubicle;stall;kiosk',
    'television;television;receiver;television;set;tv;tv;set;idiot;box;boob;tube;telly;goggle;box',
    'airplane;aeroplane;plane', 'dirt;track',
    'apparel;wearing;apparel;dress;clothes', 'pole', 'land;ground;soil',
    'bannister;banister;balustrade;balusters;handrail',
    'escalator;moving;staircase;moving;stairway',
    'ottoman;pouf;pouffe;puff;hassock', 'bottle', 'buffet;counter;sideboard',
    'poster;posting;placard;notice;bill;card', 'stage', 'van', 'ship',
    'fountain', 'conveyer;belt;conveyor;belt;conveyer;conveyor;transporter',
    'canopy', 'washer;automatic;washer;washing;machine', 'plaything;toy',
    'swimming;pool;swimming;bath;natatorium', 'stool', 'barrel;cask',
    'basket;handbasket', 'waterfall;falls', 'tent;collapsible;shelter',
    'bag', 'minibike;motorbike', 'cradle', 'oven', 'ball', 'food;solid;food',
    'step;stair', 'tank;storage;tank', 'trade;name;brand;name;brand;marque',
    'microwave;microwave;oven', 'pot;flowerpot',
    'animal;animate;being;beast;brute;creature;fauna',
    'bicycle;bike;wheel;cycle', 'lake',
    'dishwasher;dish;washer;dishwashing;machine',
    'screen;silver;screen;projection;screen', 'blanket;cover', 'sculpture',
    'hood;exhaust;hood', 'sconce', 'vase',
    'traffic;light;traffic;signal;stoplight', 'tray',
    'ashcan;trash;can;garbage;can;wastebin;ash;bin;ash-bin;ashbin;dustbin;trash;barrel;trash;bin',
    'fan', 'pier;wharf;wharfage;dock', 'crt;screen', 'plate',
    'monitor;monitoring;device', 'bulletin;board;notice;board', 'shower',
    'radiator', 'glass;drinking;glass', 'clock', 'flag',
)

# Stuff flag per class (1 = stuff, 0 = thing), same order.
ADE20K_STUFF = (
    1, 1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0,
    1, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0,
    0, 1, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 0, 0, 0,
    0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
)

# Pixel-ratio / train-count / val-count columns of object150_info.csv.
ADE20K_RATIO = (
    0.1576, 0.1072, 0.0878, 0.0621, 0.048, 0.045, 0.0398, 0.0231,
    0.0198, 0.0183, 0.0181, 0.0166, 0.016, 0.0151, 0.0118, 0.011,
    0.0109, 0.0104, 0.0104, 0.0103, 0.0098, 0.0074, 0.0067, 0.0065,
    0.0061, 0.006, 0.0053, 0.0052, 0.0046, 0.0044, 0.0044, 0.0044,
    0.0033, 0.0031, 0.003, 0.0027, 0.0026, 0.0024, 0.0024, 0.0023,
    0.0023, 0.0022, 0.0022, 0.002, 0.0019, 0.0019, 0.0018, 0.0018,
    0.0018, 0.0018, 0.0018, 0.0018, 0.0018, 0.0017, 0.0017, 0.0017,
    0.0017, 0.0017, 0.0015, 0.0015, 0.0015, 0.0015, 0.0014, 0.0014,
    0.0014, 0.0014, 0.0014, 0.0013, 0.0013, 0.0013, 0.0012, 0.0012,
    0.0012, 0.0012, 0.0011, 0.001, 0.0009, 0.0009, 0.0009, 0.0009,
    0.0009, 0.0008, 0.0008, 0.0008, 0.0008, 0.0008, 0.0007, 0.0007,
    0.0007, 0.0007, 0.0007, 0.0007, 0.0007, 0.0006, 0.0006, 0.0006,
    0.0006, 0.0006, 0.0006, 0.0006, 0.0006, 0.0006, 0.0006, 0.0006,
    0.0005, 0.0005, 0.0005, 0.0005, 0.0005, 0.0005, 0.0005, 0.0005,
    0.0005, 0.0005, 0.0005, 0.0005, 0.0005, 0.0005, 0.0005, 0.0005,
    0.0005, 0.0004, 0.0004, 0.0004, 0.0004, 0.0004, 0.0004, 0.0004,
    0.0004, 0.0004, 0.0004, 0.0004, 0.0004, 0.0004, 0.0003, 0.0003,
    0.0003, 0.0003, 0.0003, 0.0003, 0.0003, 0.0003, 0.0003, 0.0003,
    0.0003, 0.0003, 0.0003, 0.0002, 0.0002, 0.0002,
)
ADE20K_TRAIN_COUNT = (
    11664, 6046, 8265, 9336, 6678, 6604, 4023, 1906, 4688, 2423, 2874, 3068,
    5075, 1804, 6666, 4269, 1691, 3999, 2149, 3261, 3164, 709, 3296, 1191,
    1516, 667, 651, 1847, 1158, 480, 1172, 1292, 1386, 698, 781, 380,
    3089, 404, 804, 1453, 411, 1440, 800, 2650, 549, 367, 311, 1181,
    287, 468, 402, 130, 561, 880, 86, 172, 198, 930, 139, 564,
    320, 261, 275, 335, 792, 395, 1309, 1112, 266, 659, 331, 531,
    369, 144, 265, 324, 304, 170, 68, 65, 248, 492, 2510, 440,
    147, 583, 533, 1989, 71, 618, 135, 83, 178, 1003, 182, 452,
    42, 307, 965, 117, 354, 108, 557, 52, 99, 57, 292, 77,
    340, 66, 465, 50, 622, 80, 59, 531, 282, 73, 435, 136,
    116, 266, 58, 418, 319, 1193, 97, 347, 52, 246, 108, 201,
    285, 268, 1020, 1282, 528, 453, 671, 397, 92, 228, 570, 217,
    206, 130, 178, 504, 775, 421,
)
ADE20K_VAL_COUNT = (
    1172, 612, 796, 917, 641, 643, 408, 199, 460, 225, 294, 310,
    526, 190, 796, 411, 160, 441, 217, 318, 306, 75, 315, 106,
    162, 69, 57, 224, 128, 44, 98, 184, 138, 61, 73, 43,
    302, 37, 99, 153, 37, 162, 77, 298, 46, 36, 30, 122,
    23, 38, 43, 12, 64, 102, 12, 11, 18, 109, 18, 52,
    26, 29, 22, 60, 75, 49, 138, 113, 27, 66, 31, 56,
    36, 9, 29, 33, 27, 20, 6, 8, 25, 49, 269, 39,
    18, 56, 61, 239, 5, 53, 12, 5, 17, 104, 12, 50,
    6, 31, 114, 13, 35, 9, 55, 4, 5, 4, 31, 9,
    38, 3, 49, 4, 75, 9, 3, 72, 30, 7, 44, 25,
    24, 31, 12, 83, 43, 139, 23, 36, 5, 22, 13, 30,
    21, 27, 108, 122, 65, 57, 100, 44, 8, 18, 59, 22,
    19, 14, 28, 57, 96, 56,
)


def ade20k_colors() -> np.ndarray:
    """The palette as a (150, 3) uint8 array (== loadmat(color150.mat)['colors'])."""
    return np.asarray(ADE20K_COLORS_TABLE, dtype=np.uint8)


def color_encode(labelmap: np.ndarray, colors: np.ndarray | None = None) -> np.ndarray:
    """Map an integer label map [H, W] to an RGB uint8 image [H, W, 3].

    Equivalent of the reference's ``utils.colorEncode`` (utils.py:207):
    label ``l`` takes palette row ``l``; negative labels (ignore) stay black.
    """
    if colors is None:
        colors = ade20k_colors()
    colors = np.asarray(colors, dtype=np.uint8)
    labelmap = np.asarray(labelmap).astype(np.int64)
    out = np.zeros(labelmap.shape + (3,), dtype=np.uint8)
    valid = (labelmap >= 0) & (labelmap < colors.shape[0])
    out[valid] = colors[labelmap[valid]]
    return out


def write_color150_mat(path: str) -> None:
    """Write a color150.mat-compatible file ({'colors': (150,3) uint8})."""
    from scipy.io import savemat

    savemat(path, {"colors": ade20k_colors()})


def write_object150_csv(path: str) -> None:
    """Write an object150_info.csv-compatible file (same header/columns)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Idx", "Ratio", "Train", "Val", "Stuff", "Name"])
        for i in range(150):
            w.writerow([
                i + 1,
                f"{ADE20K_RATIO[i]:.4f}",
                ADE20K_TRAIN_COUNT[i],
                ADE20K_VAL_COUNT[i],
                ADE20K_STUFF[i],
                ADE20K_NAMES[i],
            ])
