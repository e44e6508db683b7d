"""Video scoring of the port: authenticity statistics, MD-VQS and the CLIP
prompt-fidelity scorer."""
