"""The benchmark's yardsticks: peaks, the algorithms' operations and bytes."""
