"""The yardstick of the kernels' roofline metrics: the card's peaks and
frozen copies of the counting functions."""
