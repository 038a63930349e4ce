from .wnn import Wnn
from .io import load_wnn, load_grayscale_image, parse_png_file
from .synthetic import make_synthetic_wnn, MNIST_LARGE_SHAPE, largest_prime_below

__all__ = ["Wnn", "load_wnn", "load_grayscale_image", "parse_png_file",
           "make_synthetic_wnn", "MNIST_LARGE_SHAPE", "largest_prime_below"]
