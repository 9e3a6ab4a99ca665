from rfw_tpu_torch.utils.collections import FlaggedStorage, TrackedStorage
from rfw_tpu_torch.utils.track import Tracked
from rfw_tpu_torch.utils.timing import Timer, Averager
from rfw_tpu_torch.utils.task import TaskPool
