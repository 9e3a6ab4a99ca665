from rfw_tpu_torch.utils.collections import FlaggedStorage
from rfw_tpu_torch.utils.timing import Timer, Averager
