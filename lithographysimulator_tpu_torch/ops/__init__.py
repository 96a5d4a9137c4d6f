"""Fourier, resize, Zernike, spectrum and Abbe imaging operators."""
