"""Mask, pupil and source models."""
