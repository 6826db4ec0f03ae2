"""Greedy CTC decoding on the device."""
