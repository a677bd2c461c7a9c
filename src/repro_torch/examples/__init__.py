"""Examples of the port, each run as `python -m repro_torch.examples.<name>`
and each with `main(argv)`: `quickstart`, `simgnn_search`, `serve_lm`,
`train_lm`."""
