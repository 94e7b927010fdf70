from .confusion import (
    confusion_matrix,
    confusion_matrix_per_weather,
    weather_confusion_matrix,
    iou_from_confusion,
)
from .evaluator import Evaluator
from .meters import AverageMeter, TimeAverageMeter
from .disparity import d1_metric, epe_metric, thres_metric
