from .infer import Evaluator
