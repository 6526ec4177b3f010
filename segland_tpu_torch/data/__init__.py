"""Host-side tile I/O and eval datasets: the port's own copies of what the
eval path needs from segland_tpu/data (numpy only; PIL, rasterio and scipy
are imported at the call that needs them).  Train-side datasets come with
training."""

from .loader import Loader
from .oem import OEMValDataset
