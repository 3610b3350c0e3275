from .predictors import PRODUCTS, BasePixrayPredictor

__all__ = ["PRODUCTS", "BasePixrayPredictor"]
