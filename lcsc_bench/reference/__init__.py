"""Plain references of the benchmark's cells, in plain PyTorch.  They
import nothing of the program and take nothing it made: the benchmark
hands them the inputs it made itself and the program's answers to
judge."""
