"""The plain LandTrendr the benchmark holds the program to (frozen copies)."""
