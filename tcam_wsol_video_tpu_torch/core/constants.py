"""The constants the stage-2 TCAM slice reads, copied from the JAX
package's core/constants.py (same names and values)."""

# tasks
STD_CL = "STD_CL"
F_CL = "F_CL"
TCAM = "TCAM"

# pooling head of the recipe
WGAP = "WGAP"

# encoders
RESNET50 = "resnet50"

# datasets
YTOV1 = "YouTube-Objects-v1.0"
NUMBER_CLASSES = {YTOV1: 10}

CROP_SIZE = 224

# seeding techniques
SEED_UNIFORM = "seed_uniform"
SEED_WEIGHTED = "seed_weighted"

# ROI selection mode of the recipe
ROI_ALL = "roi_all"

# temporal dependency modes
TIME_INSTANT = "instant"

# segmentation ignore index
SEG_IGNORE_IDX = -255

# ImageNet normalization
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
