"""The constants the port reads, copied from the JAX package's
core/constants.py (same names and values)."""

# tasks
STD_CL = "STD_CL"
F_CL = "F_CL"
TCAM = "TCAM"
C_BOX = "C_BOX"

# architectures
STDCLASSIFIER = "STDClassifier"
UNETTCAM = "UnetTCAM"
UNETFCAM = "UnetFCAM"
DENSEBOXNET = "DenseBoxNet"

# pooling heads
GAP = "GAP"
WGAP = "WGAP"
MAX_POOL = "MaxPool"
LSE_POOL = "LogSumExpPool"
WILDCAT = "WildCatCLHead"
SPATIAL_POOLINGS = (GAP, WGAP, MAX_POOL, LSE_POOL, WILDCAT)

# CAM methods of the stage-1 classifier (part of the experiment tag)
METHOD_CAM = "CAM"
METHOD_SCORECAM = "ScoreCAM"
METHOD_SSCAM = "SSCAM"
METHOD_ISCAM = "ISCAM"
METHOD_GRADCAM = "GradCam"
METHOD_GRADCAMPP = "GradCAMpp"
METHOD_SMOOTHGRADCAMPP = "SmoothGradCAMpp"
METHOD_XGRADCAM = "XGradCAM"
METHOD_LAYERCAM = "LayerCAM"
METHOD_MAXPOOL = "MaxPool"
METHOD_LSE = "LogSumExpPool"
METHOD_WILDCAT = "WildCat"
METHOD_GAP = "GAP"

CAM_METHODS = (
    METHOD_CAM, METHOD_SCORECAM, METHOD_SSCAM, METHOD_ISCAM, METHOD_GRADCAM,
    METHOD_GRADCAMPP, METHOD_SMOOTHGRADCAMPP, METHOD_XGRADCAM,
    METHOD_LAYERCAM, METHOD_MAXPOOL, METHOD_LSE, METHOD_WILDCAT, METHOD_GAP,
)

# method -> the pooling head it requires
METHOD_2_POOLINGHEAD = {
    METHOD_CAM: WGAP,
    METHOD_SCORECAM: WGAP,
    METHOD_SSCAM: WGAP,
    METHOD_ISCAM: WGAP,
    METHOD_GRADCAM: WGAP,
    METHOD_GRADCAMPP: WGAP,
    METHOD_SMOOTHGRADCAMPP: WGAP,
    METHOD_XGRADCAM: WGAP,
    METHOD_LAYERCAM: WGAP,
    METHOD_MAXPOOL: MAX_POOL,
    METHOD_LSE: LSE_POOL,
    METHOD_WILDCAT: WILDCAT,
    METHOD_GAP: GAP,
}

# methods that differentiate the head at eval time
METHOD_REQU_GRAD = {
    METHOD_CAM: False,
    METHOD_SCORECAM: False,
    METHOD_SSCAM: False,
    METHOD_ISCAM: False,
    METHOD_GRADCAM: True,
    METHOD_GRADCAMPP: True,
    METHOD_SMOOTHGRADCAMPP: True,
    METHOD_XGRADCAM: True,
    METHOD_LAYERCAM: True,
    METHOD_MAXPOOL: False,
    METHOD_LSE: False,
    METHOD_WILDCAT: False,
    METHOD_GAP: False,
}

# encoders (JAX's models/factory.get_encoder also builds "resnet101",
# which ENCODERS does not list)
RESNET50 = "resnet50"
VGG16 = "vgg16"
INCEPTIONV3 = "inceptionv3"
ENCODERS = (RESNET50, VGG16, INCEPTIONV3)

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

# ROI selection: every blob, the densest component (the largest when it
# is under p_min_area_roi of the image), or the largest component
ROI_ALL = "roi_all"
ROI_H_DENSITY = "roi_high_density"
ROI_LARGEST = "roi_largest"
ROI_SELECT = (ROI_ALL, ROI_H_DENSITY, ROI_LARGEST)

# folds under the data root when --metadata_root is relative
RELATIVE_META_ROOT = "folds/wsol-done-right-splits"

# C_BOX's minimum box size before its pre-forward re-draws a box: per
# class from the val split's GT boxes, or the constant cb_pp_box_min_size
SIZE_DATA = "size_data"
SIZE_CONST = "size_constant"
SIZE_TYPES = (SIZE_DATA, SIZE_CONST)

# the segmentation mode (seg_mode, accepted at this default only)
BINARY_MODE = "binary"

# segmentation ignore index
SEG_IGNORE_IDX = -255

# ImageNet normalization
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
