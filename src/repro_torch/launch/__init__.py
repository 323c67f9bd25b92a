"""Entry points: the train step builder and the training launcher."""
