"""Paper-faithful SURF configuration (§6 of the paper) plus the scaled
variants used by the tests, the benchmarks and the production-mesh dry run.
"""
from repro_torch.configs.base import SparseRecoveryTaskConfig, SURFConfig

# Paper scale: n=100 agents, 10 unrolled layers, K=2 hops (20 comm rounds),
# ResNet18 features (512-d), CIFAR10 (10 classes), 45 train / 15 test per
# agent, minibatch 10/agent/layer, eps=0.01.
PAPER = SURFConfig(n_agents=100, n_layers=10, filter_taps=2,
                   feature_dim=512, n_classes=10, batch_per_agent=10,
                   train_per_agent=45, test_per_agent=15, eps=0.01,
                   lr_theta=1e-2, lr_lambda=1e-2, topology="regular", degree=3)

# Classical (star) FL variant: K=1, eps=0.1, lr 1e-3 (paper §6).
PAPER_STAR = SURFConfig(n_agents=100, n_layers=10, filter_taps=1,
                        feature_dim=512, n_classes=10, batch_per_agent=10,
                        eps=0.1, lr_theta=1e-3, lr_lambda=1e-2,
                        topology="star")

# Bench scale: small feature dim.
BENCH = SURFConfig(n_agents=100, n_layers=10, filter_taps=2, feature_dim=64,
                   n_classes=10, batch_per_agent=10, eps=0.01,
                   topology="regular", degree=3)

# Smoke scale for unit tests.
SMOKE = SURFConfig(n_agents=8, n_layers=4, filter_taps=2, feature_dim=8,
                   n_classes=4, batch_per_agent=4, train_per_agent=8,
                   test_per_agent=4, eps=0.05, topology="regular", degree=3)

# Production-mesh dry-run scale: power-of-two agents so the agent axis
# shards over ('pod','data'); paper-scale feature dim.
DRYRUN = SURFConfig(n_agents=256, n_layers=10, filter_taps=2,
                    feature_dim=512, n_classes=10, batch_per_agent=10,
                    topology="ring", degree=2)

# Sparse-recovery smoke scale: the federated-LASSO task (core.tasks)
# through the SAME engine — (feature_dim, n_classes) are ignored once
# cfg.task names a non-default inner problem.
SPARSE_SMOKE = SURFConfig(n_agents=8, n_layers=4, filter_taps=2,
                          batch_per_agent=4, train_per_agent=12,
                          test_per_agent=6, eps=0.05, topology="regular",
                          degree=3,
                          task=SparseRecoveryTaskConfig(signal_dim=16,
                                                        rho=0.02,
                                                        sparsity=3,
                                                        noise=0.01))
