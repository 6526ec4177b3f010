from .ensemble import EnsembleEvaluator
from .fuse import fuse_prob_dirs, fuse_prob_maps
from .infer import Evaluator
