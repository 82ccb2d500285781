"""Selection kernels and the plain tensor ops around them."""
