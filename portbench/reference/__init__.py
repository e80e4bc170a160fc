"""The benchmark's yardstick: the plain reference (`frozen/`), the kernel's
operation count, the networks' FLOP count and the published peaks."""
