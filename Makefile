# Courier-TPU — common entry points.
# PYTHONPATH covers src/ (the package) and . (the benchmarks package).
PY      ?= python
PYPATH  := src:.

.PHONY: test test-fast bench bench-smoke lint ci clean-autotune lint-torch \
        clean-autotune-torch

test:            ## full tier-1 suite (incl. slow markers)
	PYTHONPATH=$(PYPATH) $(PY) -m pytest -x -q

test-fast:       ## fast split (excludes @slow: subprocess/multi-device/soak tests)
	PYTHONPATH=$(PYPATH) $(PY) -m pytest -q -m "not slow"

bench:           ## all paper tables + fusion + replan + replicate + faults benchmarks; writes BENCH_pipeline.json
	PYTHONPATH=$(PYPATH) $(PY) benchmarks/run.py

bench-smoke:     ## 2-token pipeline + fusion + replan + replicate + devices + faults (device-loss recovery) smoke benchmark
	PYTHONPATH=$(PYPATH) $(PY) benchmarks/run.py --smoke

lint:            ## concurrency/style lint over the package (repro.analysis.lint)
	PYTHONPATH=$(PYPATH) $(PY) -m repro.analysis lint src/repro

ci: test-fast bench-smoke lint  ## single CI entry point: fast tests, smoke benchmark, lint

clean-autotune:  ## drop the persistent block-size autotune cache
	PYTHONPATH=$(PYPATH) $(PY) -c "from repro.kernels.autotune import \
	default_cache; default_cache.clear(); print('cleared', default_cache.path)"

lint-torch:      ## the same lint over the PyTorch port (repro_torch.analysis.lint)
	PYTHONPATH=$(PYPATH) $(PY) -m repro_torch.analysis lint src/repro_torch

clean-autotune-torch:  ## drop the port's tile autotune cache
	PYTHONPATH=$(PYPATH) $(PY) -c "from repro_torch.kernels.autotune import \
	default_cache; default_cache.clear(); print('cleared', default_cache.path)"
