from .acdc import ACDC
from .acdc_city import ACDC_City
from .chamfer import label_chamfer_distance
from .citylostfound import CityLostFound, LostFound
from .cityscapes import Cityscapes, read_disp
from .device_augment import apply_augment, augment_batch, sample_crop_params
from .factory import build_transforms, get_dataset
from .grain_loader import GrainDataLoader, make_loader
from .images import read_image
from .labels import TRAIN_ID_TO_COLOR, WEATHER_DICT
from .loader import DataLoader, collate, to_device
from .png import read_png, write_png
from .synthetic import SyntheticDataset, SyntheticStereoDataset
from .transforms import (ColorJitter, Compose, CropBlackArea, FixedResize, GammaCorrection,
                         LabelBoundaryTransform, RandomAffine, RandomErasing,
                         RandomHorizontalFlip, RandomResizedCrop, RandomSquareCropAndScale,
                         RandomVerticalFlip, ReferenceRng, SetTargetSize, ThreadSafeRng,
                         ToArrays, TwoCropTransform, iter_transform_rngs)
from .stereo_transforms import (LabelDistanceTransform, RandomBrightness, RandomColor,
                                RandomContrast, RandomGamma, RandomHue, RandomSaturation,
                                StereoRandomCrop, StereoRandomVerticalFlip, StereoToNumpy,
                                StereoToPIL)
from .voc import VOCSegmentation
from .weights import balanced_class_weights, compute_class_frequencies, load_or_compute_class_weights
