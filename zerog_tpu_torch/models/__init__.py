from .wnn import Wnn
from .synthetic import make_synthetic_wnn, MNIST_LARGE_SHAPE, largest_prime_below

__all__ = ["Wnn", "make_synthetic_wnn", "MNIST_LARGE_SHAPE",
           "largest_prime_below"]
