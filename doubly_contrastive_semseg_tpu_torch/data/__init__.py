from .device_augment import apply_augment, augment_batch, sample_crop_params
from .factory import build_transforms, get_dataset
from .labels import TRAIN_ID_TO_COLOR, WEATHER_DICT
from .loader import DataLoader, collate, to_device
from .synthetic import SyntheticDataset
from .transforms import Compose, FixedResize, SetTargetSize, ThreadSafeRng, ToArrays
from .weights import balanced_class_weights, compute_class_frequencies, load_or_compute_class_weights
