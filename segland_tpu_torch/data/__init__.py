"""Host-side tile I/O and datasets: the port's own copies of what it needs
from segland_tpu/data (numpy only; PIL, rasterio and scipy are imported at
the call that needs them)."""

from .loader import Loader
from .oem import OEMTrainDataset, OEMValDataset
from .oem_ft import OEMFtTrainDataset

# registry replacing eval('dataset.'+name+...) (reference train_base.py:151)
DATASETS = {
    "oem": (OEMTrainDataset, OEMValDataset),
    "oem_ft": (OEMFtTrainDataset, OEMValDataset),
}
