"""The orchestration pieces the forecast driver uses: chaos seams, window
checkpoints and the retry policy's sentinel failure."""
