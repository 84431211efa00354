# Build/test driver (bin/packer-era Makefile parity)
.PHONY: test bench scaling goldens lint viewer

test:
	python -m pytest tests/ -q

bench:
	python bench.py

scaling:
	python benchmarks/scaling.py

goldens:
	python -c "import tests.test_goldens as g; g.regenerate()"

viewer:
	python -m vpt_jax.cli view --volume sphere:64 --renderer mcm
