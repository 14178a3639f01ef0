"""The constants the port reads, copied from the JAX package's
core/constants.py (same names and values)."""

# tasks
STD_CL = "STD_CL"
F_CL = "F_CL"
TCAM = "TCAM"

# architectures
STDCLASSIFIER = "STDClassifier"
UNETTCAM = "UnetTCAM"

# CAM method of the stage-1 classifier (part of the experiment tag)
METHOD_CAM = "CAM"

# pooling head of the recipe
WGAP = "WGAP"

# encoders
RESNET50 = "resnet50"

# datasets
YTOV1 = "YouTube-Objects-v1.0"
YTOV22 = "YouTube-Objects-v2.2"
NUMBER_CLASSES = {YTOV1: 10, YTOV22: 10}
VIDEO_DATASETS = (YTOV1, YTOV22)

# splits
TRAINSET = "train"
VALIDSET = "val"
TESTSET = "test"

CROP_SIZE = 224
RESIZE_SIZE = 256

# dataset modes: train ids are shot directories, or every id is a frame
DS_SHOTS = "shots"
DS_FRAMES = "frames"

# best-model snapshots
BEST_CL = "best_classification"
BEST_LOC = "best_localization"
CHECKPOINT_TYPES = (BEST_CL, BEST_LOC)

# validation uses the coarse tau sweep above this many samples
FAST_EVAL_SAMPLES_THRESHOLD = 1000
VALID_FAST_CAM_CURVE_INTERVAL = 0.004

# temporal dependency modes
TIME_BEFORE = "before"
TIME_AFTER = "after"
TIME_BEFORE_AFTER = "before-after"
TIME_INSTANT = "instant"
TIME_DEPENDENCY = (TIME_BEFORE, TIME_AFTER, TIME_BEFORE_AFTER, TIME_INSTANT)

# seeding techniques
SEED_UNIFORM = "seed_uniform"
SEED_WEIGHTED = "seed_weighted"
SEED_TECHS = (SEED_UNIFORM, SEED_WEIGHTED)

# ROI selection mode of the recipe
ROI_ALL = "roi_all"

# folds under the data root when --metadata_root is relative
RELATIVE_META_ROOT = "folds/wsol-done-right-splits"

# segmentation ignore index
SEG_IGNORE_IDX = -255

# ImageNet normalization
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
